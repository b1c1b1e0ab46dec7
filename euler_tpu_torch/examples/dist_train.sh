#!/usr/bin/env bash
# Distributed training launcher on one machine, on the card: N graph-service
# shards + shared-mode training (the training process serves shard 0 and
# connects a remote client to all N over the flat-file registry).
#
# Reference equivalent: tf_euler/scripts/dist_tf_euler.sh (PS + worker
# processes + ZK-registered graph shards) — here there are no parameter
# servers and no ZooKeeper (flat-file registry).
#
# Usage: euler_tpu_torch/examples/dist_train.sh DATA_DIR NUM_SHARDS \
#            [extra run_loop flags...]
set -euo pipefail

DATA_DIR=${1:?usage: dist_train.sh DATA_DIR NUM_SHARDS [flags...]}
NUM_SHARDS=${2:?usage: dist_train.sh DATA_DIR NUM_SHARDS [flags...]}
shift 2

REGISTRY=$(mktemp -d "${TMPDIR:-/tmp}/euler_registry.XXXXXX")
# the directory that holds the euler_tpu_torch package (a checkout's root
# or site-packages)
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python}

pids=()
cleanup() {
  if ((${#pids[@]})); then
    kill "${pids[@]}" 2>/dev/null || true
    wait "${pids[@]}" 2>/dev/null || true
  fi
  rm -rf "$REGISTRY"
}
trap cleanup EXIT

# Shards 1..N-1 as standalone service processes; shard 0 is served by the
# training process itself (--graph_mode=shared).
for ((s = 1; s < NUM_SHARDS; s++)); do
  "$PYTHON" -m euler_tpu_torch.graph.service \
    --data_dir "$DATA_DIR" --shard_idx "$s" --shard_num "$NUM_SHARDS" \
    --registry "$REGISTRY" &
  pids+=($!)
done

"$PYTHON" -m euler_tpu_torch \
  --data_dir "$DATA_DIR" --graph_mode shared --registry "$REGISTRY" \
  --num_processes "$NUM_SHARDS" --process_id 0 "$@"
