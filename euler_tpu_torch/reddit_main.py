"""Reddit preset CLI, on the card (counterpart of
``euler_tpu/reddit_main.py``; reference tf_euler/python/reddit_main.py:24-34:
max_id 232965, 602-dim features, 41 softmax classes).

    python -m euler_tpu_torch.reddit_main --data_dir <reddit .dat dir> \
        [overrides]
"""

import sys

from euler_tpu_torch.run_loop import main

REDDIT_DEFAULTS = [
    "--max_id", "232965",
    "--feature_idx", "1",
    "--feature_dim", "602",
    "--label_idx", "0",
    "--label_dim", "41",
    "--all_edge_type", "0,1",
    "--sigmoid_loss", "false",
]


def run(argv=None, device=None) -> int:
    """``run_loop.main`` with the preset's flags before ``argv``, on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    argv = REDDIT_DEFAULTS + list(argv if argv is not None else sys.argv[1:])
    return main(argv, device)


if __name__ == "__main__":
    sys.exit(run())
