"""The port's device beam search against stt_tpu's on the CPU: the plain scan
(`stt_tpu_torch.decode.device`) against the XLA scan
(`stt_tpu.decode.device._device_beam_scan`) and against the Pallas beam
kernel K5 in interpret mode, the state and mask helpers, chunked against
one-shot decoding, and a device-decode stream of the port's Model against
stt_tpu's.

Backpointers (bp_src, bp_char) are compared exactly; scores to 1e-4
(float32 log, exp and log1p of two libraries). The cutoff_prob fixture keeps
its cutoff away from a mass boundary, as tests/test_beam_kernel.py does:
the cumulative sums of the two sides differ in the last bit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.artifact import build_metadata as jax_build_metadata
from stt_tpu.artifact import save_artifact as jax_save_artifact
from stt_tpu.decode import device as jax_device
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import init_params
from stt_tpu.ops import beam_kernel as jax_beam_kernel
from stt_tpu.serve import Model as JaxModel
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.decode import ctc_beam_search_decoder, device
from stt_tpu_torch.decode.beam import DecoderState
from stt_tpu_torch.decode.native import NativeDecoderState
from stt_tpu_torch.decode.scorer import ScorerBase
from stt_tpu_torch.ops import beam_kernel
from stt_tpu_torch.serve import Model
from stt_tpu_torch.stream.streaming import StreamState
from test_torch_scorer import build_package

SCORE_TOL = 1e-4
LABELS = [" ", "a", "b", "c"]
# B, T, C, W, cutoff_top_n, cutoff_prob, seed, peaky, blank_id, ignored:
# the five fixtures of tests/test_beam_kernel.py
FIXTURES = {
    "basic_small": (2, 12, 8, 8, 40, 1.0, 0, False, None, ()),
    "alphabet_geometry_peaky": (2, 24, 29, 16, 40, 1.0, 2, True, None, ()),
    "cutoff_prob_path": (2, 16, 29, 24, 10, 0.9, 4, False, None, ()),
    "sort_only_top_n_path": (1, 16, 29, 16, 20, 1.0, 5, False, None, ()),
    "wav2vec2_class_layout": (2, 16, 32, 16, 40, 1.0, 6, False, 0, (1, 2)),
}


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jax_beam_kernel, "_INTERPRET", True)


def softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def fixture_probs(B, T, C, seed, peaky):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, C)).astype(np.float32)
    if peaky:
        logits = logits * 4.0
        logits[:, ::3, -1] += 6.0  # frequent strong blanks
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    lens = np.full((B,), T, np.int32)
    lens[0] = max(1, T - 3)  # masked padding frames
    return probs, lens


def assert_scores_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_plain_scan_equals_xla_scan_and_pallas_kernel(name, pallas_interpret):
    B, T, C, W, top_n, cprob, seed, peaky, blank_id, ignored = FIXTURES[name]
    probs, lens = fixture_probs(B, T, C, seed, peaky)
    scores, src, char = device._device_beam_scan(
        torch.from_numpy(probs), torch.from_numpy(lens), W, top_n, cprob, blank_id, ignored)
    s_x, src_x, char_x = jax_device._device_beam_scan(
        jnp.asarray(probs), jnp.asarray(lens), W, top_n, cprob, blank_id, tuple(ignored))
    np.testing.assert_array_equal(src.numpy(), np.asarray(src_x))
    np.testing.assert_array_equal(char.numpy(), np.asarray(char_x))
    assert_scores_close(scores.numpy(), s_x)
    _, s_k, packed = jax_beam_kernel.beam_scan(probs, lens, W, top_n, cprob, blank_id,
                                               tuple(ignored))
    src_k, char_k = jax_beam_kernel.unpack_bp(np.asarray(packed))
    np.testing.assert_array_equal(src.numpy(), src_k)
    np.testing.assert_array_equal(char.numpy(), char_k)
    assert_scores_close(scores.numpy(), s_k)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_wrapper_on_cpu_gives_the_pallas_kernels_plane_and_state(name, pallas_interpret):
    """On CPU tensors `beam_kernel.beam_scan` runs the plain version and
    returns what the TPU kernel returns: the packed int16 plane and the
    state in the kernel's layout, hashes included."""
    B, T, C, W, top_n, cprob, seed, peaky, blank_id, ignored = FIXTURES[name]
    probs, lens = fixture_probs(B, T, C, seed, peaky)
    before = beam_kernel.beam_scan.launches
    state, scores, packed = beam_kernel.beam_scan(
        torch.from_numpy(probs), torch.from_numpy(lens), W, top_n, cprob, blank_id, ignored)
    assert beam_kernel.beam_scan.launches == before  # no kernel on the CPU
    (f_k, i_k, st_k), s_k, packed_k = jax_beam_kernel.beam_scan(
        probs, lens, W, top_n, cprob, blank_id, tuple(ignored))
    assert packed.dtype == torch.int16 and packed.shape == (B, T, W)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_k))
    assert_scores_close(scores.numpy(), s_k)
    np.testing.assert_array_equal(state[1].numpy(), np.asarray(i_k))
    np.testing.assert_array_equal(state[2].numpy(), np.asarray(st_k))
    assert_scores_close(state[0].numpy(), f_k)


def test_init_state_masks_and_unpack_equal_jax():
    for got, want in zip(beam_kernel.init_state(3), jax_beam_kernel.init_state(3)):
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    for args in ((29, 28, (), True), (32, 0, (1, 2), False), (8, 3, (), False)):
        for got, want in zip(beam_kernel._masks(*args), jax_beam_kernel._masks(*args)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    packed = np.random.RandomState(0).randint(0, 2 ** 15, (2, 7, 16)).astype(np.int16)
    for got, want in zip(beam_kernel.unpack_bp(packed), jax_beam_kernel.unpack_bp(packed)):
        np.testing.assert_array_equal(got, want)
    src, char = beam_kernel.unpack_bp(packed)
    repacked = beam_kernel.pack_bp(torch.from_numpy(src), torch.from_numpy(char))
    np.testing.assert_array_equal(repacked.numpy(), packed)
    # every beam and alphabet, in one of three instances
    for W, C, blank, kind in ((128, 127, None, "narrow"), (500, 29, None, "narrow"),
                              (512, 31, None, "narrow"), (256, 63, None, "narrow"),
                              (256, 64, None, "wide"), (64, 256, None, "wide"),
                              (512, 256, None, "wide"), (513, 8, None, "huge"),
                              (64, 257, None, "huge"), (64, 256, 0, "huge"),
                              (1024, 29, None, "huge"), (500, 4096, None, "huge")):
        assert beam_kernel.supports(W, C, blank)
        assert beam_kernel.instance(W, C, blank) == kind
    assert beam_kernel.supports(1, 2) and not beam_kernel.supports(0, 29)
    assert not beam_kernel.supports(1 << 15, 1 << 15)  # past MAX_FLAT candidates a frame
    assert beam_kernel.is_narrow(500, 29) and beam_kernel.is_narrow(128, 127)
    assert not beam_kernel.is_narrow(256, 64) and not beam_kernel.is_narrow(8, 128)
    assert [beam_kernel.state_slots(W) for W in (1, 128, 129, 512, 513, 1024, 1025)] == [
        128, 128, 512, 512, 640, 1024, 1152]


def test_state_round_trip_between_kernel_layout_and_plain():
    plain = device.init_beam_state(2, 8, "cpu")
    padded = beam_kernel.state_from_plain(plain)
    for got, want in zip(padded, beam_kernel.init_state(2)):
        assert torch.equal(got, want)
    for got, want in zip(beam_kernel.state_to_plain(padded, 8), plain):
        assert torch.equal(got, want)
    # beams above 128 slots have a 512-slot state
    wide = beam_kernel.state_from_plain(device.init_beam_state(2, 200, "cpu"))
    assert wide[0].shape == (2, 2, 1, beam_kernel.WIDE_SLOTS)
    for got, want in zip(wide, beam_kernel.init_state(2, slots=beam_kernel.state_slots(200))):
        assert torch.equal(got, want)


def test_hashes_wrap_like_int32():
    h = torch.tensor([[1, 2 ** 31 - 1, -2 ** 31, -7]], dtype=torch.int32)
    c = torch.tensor([[0, 5, 28, 126]], dtype=torch.int32)
    want = (np.asarray(h.numpy()) * jax_device._H1 + (c.numpy() + 1)).astype(np.int32)
    np.testing.assert_array_equal(device._roll_hash(h, device.H1, c).numpy(), want)


def test_logaddexp_of_two_neg_inf_is_neg_inf():
    inf = float("inf")
    a = torch.tensor([-inf, -inf, 0.0, -3.0])
    b = torch.tensor([-inf, -2.0, -inf, -3.5])
    got = device.logaddexp(a, b)
    np.testing.assert_allclose(got.numpy(), np.logaddexp(a.numpy(), b.numpy()), rtol=1e-6)
    assert got[0] == -inf


def make_alphabets():
    return Alphabet().init_from_labels(LABELS), JaxAlphabet().init_from_labels(LABELS)


def assert_same_results(got, want, tol=SCORE_TOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.transcript == b.transcript
        assert a.tokens == list(b.tokens) and a.timesteps == list(b.timesteps)
        assert a.confidence == pytest.approx(b.confidence, abs=tol)


def test_streaming_decoder_chunked_with_padding_equals_one_shot():
    alphabet, jax_alphabet = make_alphabets()
    rng = np.random.RandomState(17)
    n_class, T = alphabet.size + 1, 45
    probs = softmax(rng.randn(T, n_class) * 2.0).astype(np.float32)
    dec = device.DeviceStreamingDecoder(alphabet, 24, device="cpu")
    assert dec.decode(1)[0].transcript == ""  # nothing fed yet
    for start in range(0, T, 16):
        chunk = probs[start:start + 16]
        n = chunk.shape[0]
        if n < 16:  # padded flush chunk, masked through n_valid
            chunk = np.concatenate([chunk, np.zeros((16 - n, n_class), np.float32)])
        dec.next(torch.from_numpy(chunk), n_valid=n)
    streamed = dec.decode(2)
    oneshot = device.ctc_beam_search_decoder_device(
        [probs], [T], alphabet, beam_size=24, num_results=2, device="cpu")[0]
    assert_same_results(streamed, oneshot, tol=1e-5)
    want = jax_device.ctc_beam_search_decoder_device(
        [probs], [T], jax_alphabet, beam_size=24, num_results=2)[0]
    assert_same_results(streamed, want)
    host = ctc_beam_search_decoder(probs, alphabet, 24, num_results=1)
    assert streamed[0].transcript == host[0].transcript
    assert streamed[0].timesteps == list(host[0].timesteps)
    with pytest.raises(NotImplementedError):
        dec.next_pruned()


def test_leading_silence_gate():
    """Leading frames of pure blank (>= 0.999) claim no timesteps."""
    alphabet, _ = make_alphabets()
    n_class, T = alphabet.size + 1, 12
    probs = np.full((T, n_class), 1e-6, np.float32)
    probs[:, -1] = 1.0
    probs[:5, -1] = 0.9999
    probs[5:8, -1] = 0.01
    probs[5:8, 1] = 0.98
    probs = probs / probs.sum(-1, keepdims=True)
    host = ctc_beam_search_decoder(probs, alphabet, 16)
    dev = device.ctc_beam_search_decoder_device([probs], [T], alphabet, beam_size=16,
                                                device="cpu")[0]
    assert dev[0].transcript == host[0].transcript == "a"
    assert dev[0].timesteps == list(host[0].timesteps)
    _, src, char = device.device_beam_search(probs[None], [T], 16, device="cpu")
    assert (char[0, :5] == -1).all() and (src[0, :5] == np.arange(16)).all()


def test_mixed_length_batch_decodes_each_utterance_as_if_alone():
    alphabet, jax_alphabet = make_alphabets()
    rng = np.random.RandomState(21)
    n_class = alphabet.size + 1
    lengths = [10, 25, 17]
    items = [softmax(rng.randn(t, n_class) * 2.0).astype(np.float32) for t in lengths]
    batch = device.ctc_beam_search_decoder_device(items, lengths, alphabet, beam_size=24,
                                                  num_results=2, device="cpu")
    want = jax_device.ctc_beam_search_decoder_device(items, lengths, jax_alphabet,
                                                     beam_size=24, num_results=2)
    for p, t, got, ref in zip(items, lengths, batch, want):
        solo = device.ctc_beam_search_decoder_device([p], [t], alphabet, beam_size=24,
                                                     num_results=2, device="cpu")[0]
        assert_same_results(got, solo, tol=1e-5)
        assert_same_results(got, ref)
        host = ctc_beam_search_decoder(p, alphabet, 24)
        assert got[0].transcript == host[0].transcript
        assert got[0].timesteps == list(host[0].timesteps)
    assert device.ctc_beam_search_decoder_device([], [], alphabet) == []


def test_rebuild_results_on_an_empty_beam():
    alphabet, _ = make_alphabets()
    scores = np.full((4,), -np.inf, np.float32)
    src = np.zeros((5, 4), np.int32)
    char = np.full((5, 4), -1, np.int32)
    [res] = device.rebuild_results(scores, src, char, alphabet, 1)
    assert res.transcript == "" and res.tokens == []


def test_shapes_beyond_the_kernel_take_the_plain_scan_and_count():
    """A beam wider than 512 is the kernel's huge instance on the card, so on
    the CPU it takes the wrapper's plain version like every other shape: the
    backpointers come back as the (bp_src, bp_char) pair, the wrapper counts
    no launch, and the results equal stt_tpu's device decoder (its XLA scan)
    at beam 600, one-shot and chunked."""
    alphabet, jax_alphabet = make_alphabets()
    rng = np.random.RandomState(5)
    probs = softmax(rng.randn(14, alphabet.size + 1) * 2.0).astype(np.float32)
    before = beam_kernel.beam_scan.launches
    narrow = device.ctc_beam_search_decoder_device([probs], [14], alphabet, beam_size=64,
                                                   device="cpu")[0]
    wide = device.ctc_beam_search_decoder_device([probs], [14], alphabet, beam_size=600,
                                                 device="cpu")[0]
    want = jax_device.ctc_beam_search_decoder_device([probs], [14], jax_alphabet,
                                                     beam_size=600)[0]
    assert_same_results(wide, want)
    assert wide[0].transcript == narrow[0].transcript
    state, _, bp = beam_kernel.beam_scan(torch.from_numpy(probs[None]),
                                         torch.tensor([14], dtype=torch.int32), 600)
    assert isinstance(bp, tuple) and bp[0].dtype == bp[1].dtype == torch.int32
    assert state[0].shape == (2, 1, 1, 640)
    dec = device.DeviceStreamingDecoder(alphabet, 600, device="cpu")
    dec.next(torch.from_numpy(probs[:8]))
    dec.next(probs[8:])  # a host array goes to the decoder's device
    assert_same_results(dec.decode(1), wide, tol=1e-5)
    assert beam_kernel.beam_scan.launches == before  # no kernel on the CPU


BACKTRACK_LAYOUTS = {"int16": 16, "int32": 200, "pair": 600}  # the beam that gives each plane


@pytest.mark.parametrize("layout,num_results,emissions", [
    *((layout, r, e) for layout in BACKTRACK_LAYOUTS for r in (1, 3) for e in ("peaky", "tied")),
    *((layout, 3, "no_frames") for layout in BACKTRACK_LAYOUTS),
])
def test_batch_decode_walks_the_plane_as_rebuild_results_does(layout, num_results, emissions):
    """The batch decode walks the backpointers where the scan wrote them
    (`beam_backtrack`; on CPU tensors its plain version) and sends the host
    only the chosen paths; its results equal `rebuild_results`' over the
    same plane exactly: the three forms of the plane, one and three
    results, tied scores (uniform emissions), rows shorter than T, a row
    of no frames (one live beam, fewer than num_results) and T = 0."""
    alphabet, _ = make_alphabets()
    W, C, B = BACKTRACK_LAYOUTS[layout], alphabet.size + 1, 4
    T = 0 if emissions == "no_frames" else 10
    if emissions == "peaky":
        probs = softmax(np.random.RandomState(W + num_results).randn(B, T, C) * 3.0)
    else:
        probs = np.full((B, T, C), 1.0 / C)
    probs = torch.from_numpy(probs.astype(np.float32))
    lens = [T, max(T - 3, 0), min(T, 1), 0]
    before = beam_kernel.beam_backtrack.launches
    got = device.ctc_beam_search_decoder_device(probs, lens, alphabet, beam_size=W,
                                                num_results=num_results)
    scores, src, char = device.device_beam_search(probs, lens, W)
    want = [device.rebuild_results(scores[i], src[i], char[i], alphabet, num_results)
            for i in range(B)]
    assert [[(r.transcript, r.tokens, r.timesteps, r.confidence) for r in row] for row in got] == \
        [[(r.transcript, r.tokens, r.timesteps, r.confidence) for r in row] for row in want]
    assert len(got[3]) == 1 and got[3][0].tokens == []  # the root alone
    if emissions == "tied":  # one frame: the root and each label alike, picked by slot
        assert (scores[2][np.isfinite(scores[2])] == np.float32(np.log(1.0 / C))).sum() == C
    # the plane in the form the scan wrote it; on the CPU no kernel runs
    _, scores_t, bp = device.scan(probs, torch.tensor(lens, dtype=torch.int32), W, 40, 1.0)
    assert isinstance(bp, tuple) == (layout == "pair")
    if layout != "pair":
        assert bp.dtype == (torch.int16 if layout == "int16" else torch.int32)
    paths = beam_kernel.beam_backtrack(scores_t, bp, num_results)
    assert paths.shape == (B, num_results, device.PATH_HEAD + 2 * T)
    assert device.paths_to_results(paths.numpy(), alphabet) == got
    assert beam_kernel.beam_backtrack.launches == before


@pytest.mark.parametrize("W,C,blank_id,cutoffs", [
    (64, 300, None, (1.0, 40)),  # a character alphabet past 256 symbols
    (32, 300, None, (0.95, 8)),
    (48, 256, 0, (1.0, 40)),  # 256 classes, the blank first: a character 255
])
def test_large_alphabets_go_through_the_kernel_wrapper_and_equal_stt_tpu(W, C, blank_id, cutoffs):
    """Shapes past the wide instance (the huge instance on the card) take
    the wrapper like every other, and the decoded results equal stt_tpu's
    ctc_beam_search_decoder_device, which runs them in its XLA scan."""
    cutoff_prob, cutoff_top_n = cutoffs
    labels = [chr(0x4E00 + i) for i in range(C - 1)]
    if blank_id == 0:
        labels = ["<blank>"] + labels
    alphabet = Alphabet().init_from_labels(labels)
    jax_alphabet = JaxAlphabet().init_from_labels(labels)
    rng = np.random.RandomState(C + W)
    logits = rng.randn(2, 12, C).astype(np.float32) * 3.0
    logits[:, ::4, 0 if blank_id == 0 else -1] += 5.0
    probs = softmax(logits).astype(np.float32)
    lengths = [12, 9]
    before = beam_kernel.beam_scan.launches
    got = device.ctc_beam_search_decoder_device(
        probs, lengths, alphabet, beam_size=W, cutoff_prob=cutoff_prob,
        cutoff_top_n=cutoff_top_n, num_results=2, blank_id=blank_id, device="cpu")
    want = jax_device.ctc_beam_search_decoder_device(
        probs, lengths, jax_alphabet, beam_size=W, cutoff_prob=cutoff_prob,
        cutoff_top_n=cutoff_top_n, num_results=2, blank_id=blank_id)
    for a, b in zip(got, want):
        assert_same_results(a, b)
    assert beam_kernel.beam_scan.launches == before
    assert beam_kernel.instance(W, C, blank_id) == "huge"
    _, _, bp = device.scan(torch.from_numpy(probs), torch.tensor(lengths, dtype=torch.int32), W,
                           cutoff_top_n, cutoff_prob, blank_id)
    assert isinstance(bp, tuple) and int(bp[1].max()) <= C - 1


@pytest.mark.parametrize("W,C,top_n,cprob", [(130, 5, 40, 1.0), (200, 8, 40, 1.0),
                                             (500, 29, 40, 1.0), (160, 12, 6, 0.9)])
def test_wide_beams_go_through_the_wrapper_and_equal_the_xla_scan(W, C, top_n, cprob):
    """Beams of 129 to 512 slots are the kernel's on the card, so on the CPU
    they take the wrapper's plain version: the
    packed plane is int32, the state has 512 slots, and the backpointers
    equal stt_tpu's XLA scan (which is where stt_tpu sends such beams)."""
    probs, lens = fixture_probs(2, 10, C, 40 + W, False)
    state, scores, packed = device.scan(
        torch.from_numpy(probs), torch.from_numpy(lens), W, top_n, cprob)
    assert packed.dtype == torch.int32 and packed.shape == (2, 10, W)
    assert state[0].shape == (2, 2, 1, beam_kernel.WIDE_SLOTS)
    s_x, src_x, char_x = jax_device._device_beam_scan(
        jnp.asarray(probs), jnp.asarray(lens), W, top_n, cprob, None, ())
    src, char = beam_kernel.unpack_bp(packed.numpy())
    np.testing.assert_array_equal(src, np.asarray(src_x))
    np.testing.assert_array_equal(char, np.asarray(char_x))
    assert_scores_close(scores.numpy(), s_x)
    assert torch.equal(beam_kernel.pack_bp(torch.from_numpy(src), torch.from_numpy(char)), packed)
    # chunks chain through the 512-slot state
    state2, parts = None, []
    for t0 in (0, 6):
        state2, scores2, bp = device.scan(
            torch.from_numpy(probs[:, t0:t0 + 6]).contiguous(),
            torch.from_numpy(np.clip(lens - t0, 0, 6).astype(np.int32)), W, top_n, cprob,
            state=state2)
        parts.append(bp[:, : min(6, 10 - t0)])
    assert torch.equal(torch.cat(parts, dim=1), packed)
    assert torch.equal(scores2, scores)


@pytest.mark.parametrize("W,C", [(32, 256), (160, 200)])
def test_byte_alphabets_go_through_the_wrapper_and_equal_the_xla_scan(W, C):
    """Up to 256 classes the shape is the kernel's wide instance on the
    card, so on the CPU it takes the wrapper's plain version; the backpointers equal stt_tpu's XLA scan, where
    stt_tpu sends shapes its Pallas kernel does not take."""
    probs, lens = fixture_probs(2, 10, C, 70 + W, False)
    _, scores, packed = device.scan(torch.from_numpy(probs), torch.from_numpy(lens), W, 40, 1.0)
    assert packed.dtype == (torch.int16 if W <= beam_kernel.WSLOTS else torch.int32)
    s_x, src_x, char_x = jax_device._device_beam_scan(
        jnp.asarray(probs), jnp.asarray(lens), W, 40, 1.0, None, ())
    src, char = beam_kernel.unpack_bp(packed.numpy())
    np.testing.assert_array_equal(src, np.asarray(src_x))
    np.testing.assert_array_equal(char, np.asarray(char_x))
    assert char.max() <= C - 2  # the blank, last, is never a character
    assert_scores_close(scores.numpy(), s_x)


def test_host_arrays_go_to_the_card_unless_the_caller_asks_for_the_cpu():
    """The entry points move host arrays to `device`, "cuda" by default, so
    without a card they raise; tensors stay where they lie."""
    alphabet, _ = make_alphabets()
    probs = softmax(np.random.RandomState(3).randn(6, alphabet.size + 1)).astype(np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device.ctc_beam_search_decoder_device([probs], [6], alphabet, beam_size=4)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device.device_beam_search(probs[None], [6], 4)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device.DeviceStreamingDecoder(alphabet, 4)
    on_cpu = device.ctc_beam_search_decoder_device([probs], [6], alphabet, beam_size=4,
                                                   device="cpu")[0]
    as_tensor = device.ctc_beam_search_decoder_device(
        torch.from_numpy(probs)[None], [6], alphabet, beam_size=4)[0]  # a CPU tensor stays
    assert_same_results(on_cpu, as_tensor, tol=0)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    labels = list(" abcdefghijklmnopqrstuvwxyz'")
    alphabet = JaxAlphabet().init_from_labels(labels)
    config = JaxModelConfig(n_hidden=64, n_cell_dim=64, n_out=len(labels) + 1,
                            dropout_rates=(0.0,) * 6)
    params = jax.device_get(init_params(jax.random.PRNGKey(11), config))
    # a large output bias spread makes the emissions peaky, so the beams of
    # the two packages cannot differ through near-ties of flat emissions
    params["layer_6"]["b"] = (np.random.RandomState(0).randn(len(labels) + 1) * 3).astype(np.float32)
    params["layer_6"]["w"] = params["layer_6"]["w"] * 20.0
    meta = jax_build_metadata(config, JaxFeatureConfig(), alphabet, beam_width=16)
    return jax_save_artifact(str(tmp_path_factory.mktemp("dd") / "m"), params, meta, alphabet)


def speech_like(seed, seconds):
    rs = np.random.RandomState(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    audio = sum(0.15 * np.sin(2 * np.pi * rs.uniform(100, 2000) * t) for _ in range(3))
    return (audio + 0.03 * rs.randn(n)).astype(np.float32)


def test_model_device_decode_stream_against_stt_tpu(artifact, pallas_interpret):
    model, jax_model = Model(artifact, device="cpu"), JaxModel(artifact)
    audio = speech_like(2, 2.6)

    def run(m):
        stream = m.create_stream(device_decode=True)
        mids = []
        for start in range(0, len(audio), 7000):
            stream.feed_audio_content(audio[start:start + 7000])
            mids.append(stream.intermediate_decode())
        return stream, mids, stream.finish_stream_with_metadata(2)

    stream, mids, meta = run(model)
    jax_stream, jax_mids, jax_meta = run(jax_model)
    assert stream._state.device_decode and not stream._state.device_prune
    assert jax_stream._state.decoder._use_kernel  # the Pallas kernel, interpreted
    assert mids == jax_mids and mids[-1] != ""
    for got, want in zip(meta.transcripts, jax_meta.transcripts):
        assert got.transcript == want.transcript
        assert [t.timestep for t in got.tokens] == [t.timestep for t in want.tokens]
        assert got.confidence == pytest.approx(want.confidence, abs=1e-3)
    # nothing decode-related reached the host while feeding
    assert stream._state.probs_history.shape == (0, 29)
    # the stream's transcript is the batch decoder's on the same emissions
    _, probs = model.stt_with_emissions(audio)
    batch = device.ctc_beam_search_decoder_device(
        [probs], [len(probs)], model.alphabet, beam_size=16, num_results=2, device="cpu")[0]
    assert [c.transcript for c in meta.transcripts] == [r.transcript for r in batch]


def test_a_scorer_turns_device_decode_off(artifact, tmp_path):
    """The beam kernel decodes without a language model, so a stream with a
    scorer decodes on the host, in the native decoder, even when asked for
    device_decode."""
    model = Model(artifact, device="cpu")
    state = StreamState(model._runtime, beam_width=8, device_decode=True)
    assert state.device_decode and isinstance(state.decoder, device.DeviceStreamingDecoder)
    model.enable_external_scorer(build_package(tmp_path, "lm.scorer"))
    with_scorer = StreamState(model._runtime, beam_width=8, device_decode=True,
                              scorer=model.scorer)
    assert with_scorer.device_decode is False
    assert isinstance(with_scorer.decoder, NativeDecoderState)
    stream = model.create_stream(device_decode=True)
    assert not stream._state.device_decode
    stream.feed_audio_content(speech_like(4, 1.0))
    assert isinstance(stream.finish_stream(), str)
    # a scorer without a file takes the Python decoder, still on the host
    probe = StreamState(model._runtime, beam_width=8, device_decode=True, scorer=ScorerBase())
    assert probe.device_decode is False and type(probe.decoder) is DecoderState
    # stt_with_emissions keeps forcing it off: the emissions reach the host
    _, probs = model.stt_with_emissions(speech_like(3, 1.0))
    assert probs.shape[0] > 0
