"""The port's decoders against the JAX package's on the same seeded
probabilities: the Python beam decoder and the native one, each against
its counterpart (results equal, confidences too, since both run the same
float64 host arithmetic), emission pruning in its three cutoff modes, and
greedy decoding.

The probabilities hold an exact tie of two classes. There the native and
the Python decoder may keep different prefixes (in both packages), so
each is held against its own counterpart here; tests/test_torch_native_decoder.py
holds the four against one another on inputs without ties.

Pruning: indices, counts and blank probabilities are equal. logp is equal
to within one float32 ulp: numpy's float32 log is not correctly rounded,
torch's is, and they differ in the last bit on a few percent of inputs.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.ctc import greedy_decode as jax_greedy_decode
from stt_tpu.decode.beam import DecoderState as JaxDecoderState
from stt_tpu.decode.beam import make_decoder_state as jax_make_decoder_state
from stt_tpu.decode.device import prune_emissions_host as jax_prune_host
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.ctc import greedy_decode
from stt_tpu_torch.decode import make_decoder_state
from stt_tpu_torch.decode.device import prune_emissions, prune_emissions_host
from stt_tpu_torch.decode.beam import DecoderState
from stt_tpu_torch.decode.native import NativeDecoderState
from stt_tpu_torch.decode.scorer import ScorerBase

LABELS = list(" abcdefghijklmnopqrstuvwxyz'")
CUTOFFS = [(40, 1.0), (10, 1.0), (10, 0.9), (5, 0.5)]  # identity, sort, truncate


def seeded_probs(seed, T=60, C=len(LABELS) + 1):
    rs = np.random.RandomState(seed)
    logits = rs.randn(T, C) * 2.5
    logits[:, -1] += 1.5  # blank-heavy, like a real acoustic model
    logits[:4, -1] += 8.0  # leading silence exercises the delayed start
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    probs[10, 3] = probs[10, 5]  # a tie the sort must order by class index
    return probs


def results(decoder, n):
    return [(r.transcript, list(r.tokens), list(r.timesteps), r.confidence)
            for r in decoder.decode(n)]


BEAM_CASES = [(8, (40, 1.0)), (16, (10, 0.9)), (16, (10, 1.0))]


@pytest.mark.parametrize("beam,cutoff", BEAM_CASES)
def test_beam_decoder_matches_jax(beam, cutoff):
    top_n, prob = cutoff
    probs = seeded_probs(beam + top_n)
    ours = make_decoder_state(Alphabet().init_from_labels(LABELS), beam, prob, top_n,
                              implementation="python")
    theirs = JaxDecoderState(JaxAlphabet().init_from_labels(LABELS), beam, prob, top_n)
    for start in range(0, len(probs), 16):  # streamed, with decodes between
        ours.next(probs[start:start + 16])
        theirs.next(probs[start:start + 16])
        assert results(ours, 1) == results(theirs, 1)
    got, want = results(ours, 4), results(theirs, 4)
    assert len(got) == 4 and got == want


@pytest.mark.parametrize("beam,cutoff", BEAM_CASES)
def test_native_beam_decoder_matches_jax_native(beam, cutoff):
    top_n, prob = cutoff
    probs = seeded_probs(beam + top_n)
    ours = make_decoder_state(Alphabet().init_from_labels(LABELS), beam, prob, top_n)
    assert isinstance(ours, NativeDecoderState)  # the default
    theirs = jax_make_decoder_state(JaxAlphabet().init_from_labels(LABELS), beam, prob, top_n,
                                    implementation="native")
    for start in range(0, len(probs), 16):  # streamed, with decodes between
        ours.next(probs[start:start + 16])
        theirs.next(probs[start:start + 16])
        assert results(ours, 1) == results(theirs, 1)
    got, want = results(ours, 4), results(theirs, 4)
    assert len(got) == 4 and got == want


def test_next_pruned_matches_next():
    probs = seeded_probs(5)
    alphabet = Alphabet().init_from_labels(LABELS)
    a = make_decoder_state(alphabet, 16, 0.95, 12)
    b = make_decoder_state(alphabet, 16, 0.95, 12)
    a.next(probs)
    b.next_pruned(*prune_emissions_host(probs, 12, 0.95))
    # the pruned logp is float32, next() takes the log in float64
    for got, want in zip(results(b, 3), results(a, 3)):
        assert got[:3] == want[:3]
        assert got[3] == pytest.approx(want[3], abs=1e-4)


@pytest.mark.parametrize("top_n,prob", CUTOFFS)
def test_prune_emissions_matches_host(top_n, prob):
    probs = seeded_probs(top_n)
    want = jax_prune_host(probs, top_n, prob)
    host = prune_emissions_host(probs, top_n, prob)
    device = [a.numpy() for a in prune_emissions(torch.from_numpy(probs), top_n, prob)]
    for got in (host, device):
        idx, logp, count, blank = got
        assert idx.dtype == np.int32 and count.dtype == np.int32
        np.testing.assert_array_equal(idx, want[0])
        np.testing.assert_array_equal(count, want[2])
        np.testing.assert_array_equal(blank, want[3])
        np.testing.assert_array_max_ulp(logp, want[1], maxulp=1)
    np.testing.assert_array_equal(host[1], want[1])  # the numpy copy is exact


def test_greedy_matches_jax():
    rs = np.random.RandomState(9)
    logits = rs.randn(3, 30, 29).astype(np.float32)
    logits[:, 5:9] = logits[:, 5:6]  # repeats collapse
    lengths = np.array([30, 17, 4], np.int32)
    got = greedy_decode(torch.from_numpy(logits), torch.from_numpy(lengths))
    assert got == jax_greedy_decode(jnp.asarray(logits), jnp.asarray(lengths))
    assert greedy_decode(torch.from_numpy(logits)) == jax_greedy_decode(jnp.asarray(logits))


def test_unported_decoder_options_raise():
    """What replaced the refusal of 'native' and of scorers: 'native' and
    'auto' take the C++ decoder; a scorer without a file (here a bare
    ScorerBase) takes the Python decoder under 'auto' and raises under
    'native'; an unknown implementation raises."""
    alphabet = Alphabet().init_from_labels(LABELS)
    assert isinstance(make_decoder_state(alphabet, 8, implementation="native"), NativeDecoderState)
    assert isinstance(make_decoder_state(alphabet, 8), NativeDecoderState)
    assert type(make_decoder_state(alphabet, 8, implementation="python")) is DecoderState
    assert type(make_decoder_state(alphabet, 8, scorer=ScorerBase())) is DecoderState
    with pytest.raises(RuntimeError, match="no path"):
        make_decoder_state(alphabet, 8, scorer=ScorerBase(), implementation="native")
    with pytest.raises(ValueError, match="unknown"):
        make_decoder_state(alphabet, 8, implementation="cuda")
