"""PPI preset CLI, on the card (counterpart of ``euler_tpu/ppi_main.py``;
reference tf_euler/python/ppi_main.py:24-33: max_id 56944, 50-dim
features, 121 sigmoid classes).

    python -m euler_tpu_torch.ppi_main --data_dir <ppi .dat dir> [overrides]
"""

import sys

from euler_tpu_torch.run_loop import main

PPI_DEFAULTS = [
    "--max_id", "56944",
    "--feature_idx", "1",
    "--feature_dim", "50",
    "--label_idx", "0",
    "--label_dim", "121",
    "--all_edge_type", "0,1",
]


def run(argv=None, device=None) -> int:
    """``run_loop.main`` with the preset's flags before ``argv``, on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    argv = PPI_DEFAULTS + list(argv if argv is not None else sys.argv[1:])
    return main(argv, device)


if __name__ == "__main__":
    sys.exit(run())
