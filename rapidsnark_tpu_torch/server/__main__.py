"""proverServer entry point.

Usage (main_proofserver.cpp:11-25 contract):
    python -m rapidsnark_tpu_torch.server <port> <circuit1.zkey> ... <circuitN.zkey>

Serves on the CUDA card and raises without one.
"""

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        sys.stderr.write(
            "Invalid number of parameters:\n"
            "Usage: proverServer <port> <circuit1.zkey> <circuit2.zkey> "
            "... <circuitN.zkey> \n")
        return 255
    from .http import serve
    serve(argv[1:], int(argv[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
