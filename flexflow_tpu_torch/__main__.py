"""``python -m flexflow_tpu_torch --serve|--train [flags]``: the drivers."""

from __future__ import annotations

import sys


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--serve":
        from flexflow_tpu_torch.serve.driver import main as serve_main

        return serve_main(sys.argv[2:])
    if len(sys.argv) >= 2 and sys.argv[1] == "--train":
        from flexflow_tpu_torch.runtime.driver import main as train_main

        return train_main(sys.argv[2:])
    print(
        "usage: python -m flexflow_tpu_torch --serve [serve flags...]\n"
        "       python -m flexflow_tpu_torch --train [train flags...]\n"
        "       python -m flexflow_tpu_torch --serve --help | --train --help",
        file=sys.stderr,
    )
    return 0 if len(sys.argv) >= 2 and sys.argv[1] in ("-h", "--help") else 2


if __name__ == "__main__":
    sys.exit(main())
