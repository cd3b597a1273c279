"""`python -m localai_tpu_torch.backend --addr 127.0.0.1:PORT [--device cpu]`"""
import argparse
import sys

from localai_tpu_torch.backend.server import serve_blocking


def main(argv=None):
    p = argparse.ArgumentParser(prog="localai_tpu_torch.backend")
    p.add_argument("--addr", default="127.0.0.1:50051")
    p.add_argument("--device", default=None,
                   help="device for the model (default: the CUDA device; "
                        "'cpu' runs the plain PyTorch versions)")
    args = p.parse_args(argv)
    return serve_blocking(addr=args.addr, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
