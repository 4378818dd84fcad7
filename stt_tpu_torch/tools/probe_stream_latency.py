"""Single-stream chunk decode latency: the beam kernel (K5) against the
host decoder fed pruned emissions (the port of
tools/probe_stream_latency.py).

500 frames of speech-like emissions over the alphabet's classes, decoded
in chunks of 16 frames at beam 64 by `DeviceStreamingDecoder` (one K5
launch a chunk) and by `prune_emissions` + the native host decoder's
`next_pruned`. Prints both times and whether the transcripts are equal.
Where stt_tpu's probe printed whether its decoder took the kernel, this
one prints the device and K5's launches: on the card every chunk launches
K5.

The alphabet defaults to the reference's, as stt_tpu's probe does; give
another with --alphabet (the reference is not everywhere).

Run: python -m stt_tpu_torch.tools.probe_stream_latency
       [--alphabet data/alphabet.txt] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.decode.beam import make_decoder_state
from stt_tpu_torch.decode.device import DeviceStreamingDecoder, prune_emissions
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.ops import beam_kernel

REFERENCE_ALPHABET = "/root/reference/data/alphabet.txt"
FRAMES = 500
CHUNK = 16
BEAM = 64


def speechlike_probs(rng, batch, frames, n_class):
    """Blank-dominated emissions with letter bursts: the shape real CTC
    posteriors take, which is what beam-search cost depends on (a copy of
    the repository's bench.py speechlike_probs)."""
    probs = np.full((batch, frames, n_class), 1e-4, np.float32)
    probs[..., -1] = 1.0  # blank
    for b in range(batch):
        t = 0
        while t < frames:
            t += int(rng.randint(2, 6))
            if t >= frames:
                break
            c = int(rng.randint(0, n_class - 1))
            dom = rng.uniform(0.5, 0.95)
            probs[b, t, -1] = 1.0 - dom
            probs[b, t, c] = dom
            # a second candidate keeps the beam busy
            c2 = int(rng.randint(0, n_class - 1))
            probs[b, t, c2] += (1.0 - dom) * 0.5
    return probs / probs.sum(-1, keepdims=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe(alphabet_path: str = REFERENCE_ALPHABET, device="cuda") -> dict:
    device = resolve_device(device)
    alphabet = Alphabet(alphabet_path)
    C = alphabet.size + 1
    rng = np.random.RandomState(0)
    T = FRAMES
    probs_np = speechlike_probs(rng, 1, T, C)[0]
    probs_dev = torch.from_numpy(probs_np).to(device)
    CH = CHUNK

    # kernel streaming decoder
    dec = DeviceStreamingDecoder(alphabet, beam_size=BEAM, device=device)
    dec.next(probs_dev[:CH])  # build and warm
    dec = DeviceStreamingDecoder(alphabet, beam_size=BEAM, device=device)
    launches = beam_kernel.beam_scan.launches
    sync(device)
    t0 = time.time()
    for i in range(0, T, CH):
        dec.next(probs_dev[i:i + CH])
    r = dec.decode(1)
    sync(device)
    t_k = time.time() - t0
    launches = beam_kernel.beam_scan.launches - launches
    print(f"kernel streaming: {t_k * 1e3:.1f}ms total, {t_k / (T // CH) * 1e3:.2f}ms/chunk, "
          f"device: {device}, K5 launches: {launches}")

    # host decoder fed device-pruned chunks
    state = make_decoder_state(alphabet, BEAM, 1.0, 40, None, None, "auto")
    prune_emissions(probs_dev[None], 40, 1.0)
    sync(device)
    t0 = time.time()
    idx, logp, cnt, blank = prune_emissions(probs_dev[None], 40, 1.0)
    i2, l2, c2, b2 = (x[0].cpu().numpy() for x in (idx, logp, cnt, blank))
    for i in range(0, T, CH):
        state.next_pruned(i2[i:i + CH], l2[i:i + CH], c2[i:i + CH], b2[i:i + CH])
    r2 = state.decode(1)
    t_h = time.time() - t0
    print(f"host streaming:   {t_h * 1e3:.1f}ms total, {t_h / (T // CH) * 1e3:.2f}ms/chunk")
    equal = r[0].transcript == r2[0].transcript
    print("transcripts equal:", equal)
    return {"kernel_ms": t_k * 1e3, "host_ms": t_h * 1e3, "chunks": -(-T // CH),
            "k5_launches": launches, "device": str(device), "transcripts_equal": equal,
            "transcript": r[0].transcript}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--alphabet", default=REFERENCE_ALPHABET)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu asks for the CPU)")
    args = parser.parse_args(argv)
    return probe(args.alphabet, args.device)


if __name__ == "__main__":
    main()
