"""python -m stt_tpu_torch.train [--device cpu] --train_files ... : the
training command line. It trains on the card unless --device cpu is
given; every other flag is an SttConfig field."""

import argparse

from stt_tpu_torch.config import initialize_globals_from_cli
from stt_tpu_torch.train.trainer import train


def main(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda")
    args, rest = parser.parse_known_args(argv)
    train(initialize_globals_from_cli(rest, device=args.device), device=args.device)


if __name__ == "__main__":
    main()
