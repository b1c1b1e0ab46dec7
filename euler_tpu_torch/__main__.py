"""``python -m euler_tpu_torch``: the training CLI (``run_loop.main``)."""

import sys

from euler_tpu_torch.run_loop import main

if __name__ == "__main__":
    sys.exit(main())
