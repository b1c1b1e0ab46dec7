"""Training loops (counterpart of ``euler_tpu/train.py``): ``train``, the
per-step loop over host roots with prefetch, checkpoints and resume;
``make_scan_train``, chunks of steps with roots drawn on the card;
``evaluate`` and ``save_embedding``."""

from __future__ import annotations

import functools
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from euler_tpu_torch.checkpoint import Checkpointer
from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.graph import device as device_graph
from euler_tpu_torch.models import base
from euler_tpu_torch.nn import metrics
from euler_tpu_torch.parallel import pipeline, prefetch

log = logging.getLogger("euler_tpu_torch")

class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad``, which ``torch.optim.Adagrad`` is not: each
    parameter's accumulator starts at ``initial_accumulator_value`` (0.1,
    not 0), and the update is ``-lr * g * rsqrt(acc + eps)`` with ``eps``
    inside the root (1e-7), where an accumulator of 0 gives an update of
    0 (torch divides by ``sqrt(acc) + 1e-10``)."""

    def __init__(self, params, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                acc = state["sum"]
                acc.addcmul_(p.grad, p.grad)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                    torch.zeros_like(acc))
                p.add_(scale.mul_(p.grad).mul_(-group["lr"]))
        return loss


OPTIMIZERS = {
    # optax.sgd is plain SGD, and with momentum optax.trace: t = g + m t,
    # the step -lr t, which is torch's SGD with dampening 0
    "sgd": torch.optim.SGD,
    "momentum": functools.partial(torch.optim.SGD, momentum=0.9),
    "adagrad": Adagrad,
    # optax.adam's defaults are torch's: b1 0.9, b2 0.999, eps 1e-8 added
    # outside the square root
    "adam": torch.optim.Adam,
}


def get_optimizer(name: str, lr: float):
    """A factory ``params -> torch.optim.Optimizer`` (the part optax's
    ``init`` plays), for ``Model.init_state``: the JAX package's
    ``sgd``, ``momentum`` (0.9), ``adagrad`` and ``adam``."""
    if name not in OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {name!r}; have {sorted(OPTIMIZERS)}"
        )
    return functools.partial(OPTIMIZERS[name], lr=lr)


def _metric_value(name: str, acc) -> float:
    if name == "f1":
        return metrics.f1_from_counts(acc)
    if name == "auc":
        return metrics.auc_from_counts(acc)
    return float(acc[0] / max(acc[1], 1))  # running mean


def _metric_accumulate(name: str, acc, value):
    value = np.asarray(value)
    if name in ("f1", "auc"):
        return acc + value
    return np.array([acc[0] + float(value), acc[1] + 1.0])


def _metric_zero(name: str):
    if name == "f1":
        return np.zeros(3)
    if name == "auc":
        return np.zeros((2, metrics.AUC_BINS))
    return np.zeros(2)


def _step_seed(seed: int, step: int) -> int:
    """The device draws' seed of step ``step`` of a run seeded ``seed``:
    distinct across the steps of a run and below 2^32, as
    ``graph.device.stream_words`` wants."""
    return (seed * 1_000_003 + step + 1) % (1 << 32)


def worker_seed(seed: int, rank: int, widx: int) -> int:
    """The engine seed of prefetch worker ``widx`` on data row ``rank``
    of a run seeded ``seed``, as the JAX package folds its process index
    in: ranks with one stream each would draw the same roots and collapse
    the global batch to one rank's."""
    return seed * 1_000_003 + rank * 8_191 + widx + 1


def _leader(mesh) -> bool:
    """True where this process speaks for the run: no mesh, or rank 0."""
    return mesh is None or mesh.rank == 0


def _follower(mesh) -> bool:
    """True on a model column past the first: it draws no host batch of
    its own (its engine draws would differ) and takes its data row's
    from ``_row_batch``."""
    return mesh is not None and mesh.model_rank > 0


def _row_batch(mesh, batch):
    """The host batch that every rank of this data row's model group
    shares: the row's first rank's ``batch``, broadcast to the followers
    (which pass None); ``batch`` itself without a model axis."""
    if mesh is None or mesh.shape["model"] == 1:
        return batch
    return mesh.broadcast_object(batch)


def _fence(t) -> None:
    """Wait for the work queued before ``t`` was produced: the stream's
    queue on the card (nothing to wait for on the CPU)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def _start_profiler(profile_dir: str, dev, warmup: int, active: int):
    """A started ``torch.profiler`` capture into ``profile_dir`` (CPU
    activity, and CUDA on the card) on a schedule of ``warmup`` steps,
    whose events are dropped, then ``active`` recorded ones: a capture
    can miss the device events of its first moments after a start, and
    the warm-up step takes that loss."""
    from torch.profiler import (ProfilerActivity, profile, schedule,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   schedule=schedule(wait=0, warmup=warmup, active=active,
                                     repeat=1),
                   on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    return prof


def _stamp_align() -> None:
    """The alignment marker, in the recorded part of a capture."""
    from euler_tpu_torch.trace import align_annotation

    with align_annotation():
        pass


def train(
    model,
    graph,
    source_fn: Callable[[int], np.ndarray],
    num_steps: int,
    optimizer: str = "adam",
    learning_rate: float = 0.01,
    mesh=None,
    log_every: int = 100,
    seed: int = 42,
    prefetch_depth: int = 2,
    prefetch_threads: int = 2,
    sampler_depth: int = 2,
    state: Optional[dict] = None,
    log_fn=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    profile_dir: Optional[str] = None,
    profile_steps: tuple = (10, 20),
    step_hook=None,
    phase_profile: Optional[bool] = None,
    device=None,
):
    """Train on one device (the card unless ``"cpu"`` is asked for) and
    return ``(state, history)``.

    ``source_fn(step)`` gives the step's root ids (or a model's
    structured inputs, such as LasGNN's ``{"label", "groups"}``). Prefetch
    workers call
    it and, for a host-sampling model, ``model.sample(graph, roots)``,
    ``prefetch_depth`` steps ahead on ``prefetch_threads`` threads, each
    seeding its engine RNG from ``seed``; the training thread uploads the
    batch (``models.base.to_device``) or, for a device-sampling model,
    makes the step's device batch from the roots and the step's seed,
    then runs ``model.make_train_step()``.

    ``checkpoint_dir`` saves every ``checkpoint_every`` steps (default a
    tenth of the run) and at the end, and resumes from its latest step;
    ``state`` resumes from a given state. ``step_hook(step)`` runs on the
    training thread after every step. Every ``log_every`` steps the loop
    syncs on the loss and appends to ``history`` the loss, the metric
    over the window, steps/s, and the input pipeline's numbers: the mean
    wait for a batch (``input_stall_ms``), the steps that waited over a
    millisecond (``stalled_steps``) and the mean build time of a batch in
    its worker (``sample_ms``).

    On a remote graph (``graph.mode == "remote"``) a host-sampling model
    samples through ``parallel.pipeline`` instead, when ``sampler_depth``
    is above 0: one sampler thread keeps ``sampler_depth`` steps submitted
    (``model.sample_start``, for SupervisedGraphSage one
    ``Graph.sample_fanout_async``) and finishes them in order
    (``model.sample_finish``), so the next steps' wire time overlaps this
    step; ``sample_ms`` is then that thread's wait on a step's op. A
    local graph has no wire to overlap and keeps ``prefetch``.

    ``phase_profile`` records the step phases into the engine's telemetry
    (``telemetry.record_phase``): ``input_stall`` at the consumer and the
    queue gauges (in ``prefetch`` or ``pipeline``), ``sample`` around the
    batch's build in its worker (the roots, and for a host-sampling model
    its ``sample``), ``h2d`` around the upload on the training thread
    (``models.base.to_device``, or ``device_sample_batch``'s roots),
    ``device`` around the step, fenced on its loss (the loop then waits
    for each step: the card no longer runs ahead of the host, while the
    prefetch workers still overlap it), ``host`` for the rest of the
    loop's body and ``step`` from one body's end to the next. None (the
    default) follows the telemetry kill-switch. ``devprof.count_h2d``
    counts each upload's bytes and ``count_d2h`` each window's fetched
    losses and metrics; the first step logs the compiles it took
    (``devprof.compile_summary``: kernel builds and CUDA-graph captures).
    ``profile_dir`` runs ``torch.profiler`` (CPU and, on the card, CUDA
    activities) over steps ``profile_steps[0]`` to ``profile_steps[1]``
    (after one warm-up step, whose events it drops) and writes the
    capture there through ``tensorboard_trace_handler``, stamped with
    ``trace.align_annotation`` where its recording starts, so
    ``trace.write_trace(..., profile_dir=)`` puts its kernels on the
    phases' timeline.

    ``mesh`` (a ``parallel.mesh.Mesh`` over a process group) trains this
    process's rank of it on ``mesh.device``: ``source_fn(step)`` gives
    the rank's data row its own share of the global batch (the ranks of
    a row's model group train on its first rank's, broadcast), the state
    is initialised alike on every rank and its tables row-sharded over
    the model axis (a given ``state`` must be the rank's, from
    ``init_state(mesh=)``), the step all-reduces the gradients
    (``make_train_step(mesh)``) and returns the global batch's loss and
    metric. Each prefetch worker seeds its engine with ``worker_seed(seed,
    data row, widx)``. Only rank 0 logs; every rank takes part in a
    checkpoint, which rank 0 writes (``Checkpointer(mesh=)``)."""
    from euler_tpu_torch import devprof, telemetry

    if phase_profile is None:
        phase_profile = telemetry.telemetry_enabled()
    record_phase = telemetry.record_phase
    dev = resolve_device(device if mesh is None or mesh.device is None
                         else mesh.device)
    say = (log_fn or log.info) if _leader(mesh) else (lambda msg: None)
    if state is None:
        state = model.init_state(
            graph, get_optimizer(optimizer, learning_rate), device=dev,
            seed=seed, mesh=mesh)
    ckpt = None
    start_step = 0
    if checkpoint_dir:
        ckpt = Checkpointer(checkpoint_dir, mesh=mesh)
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(state, latest)
            start_step = latest
            say(f"resumed from {checkpoint_dir} at step {latest}")
        if checkpoint_every <= 0:
            checkpoint_every = max(num_steps // 10, 1)
    step_fn = model.make_train_step(mesh=mesh)
    follower = _follower(mesh)
    row_rank = 0 if mesh is None else mesh.data_rank

    def make_batch(step):
        if follower:
            return None
        t0 = time.perf_counter()
        inputs = source_fn(step)
        batch = (inputs if model.device_sampling
                 else model.sample(graph, inputs))
        if phase_profile:
            record_phase("sample", (time.perf_counter() - t0) * 1e6,
                         step=step)
        return batch

    def finish_batch(step, pending):
        if follower:
            return None
        # "sample" is the wait on the step's async op
        t0 = time.perf_counter()
        batch = model.sample_finish(graph, pending)
        if phase_profile:
            record_phase("sample", (time.perf_counter() - t0) * 1e6,
                         step=step)
        return batch

    use_pipeline = (sampler_depth > 0 and not model.device_sampling
                    and getattr(graph, "mode", None) == "remote")

    def seed_worker(widx: int):
        # per-worker sampler streams from the run seed (the engine's RNG
        # is thread-local); a graph without the engine samples nothing
        engine = getattr(graph, "_lib", None)
        if engine is not None:
            engine.eg_seed(worker_seed(seed, row_rank, widx))

    name = model.metric_name
    history = []
    timings: dict = {}
    window_metrics = []
    last_loss = None
    steps_done = start_step
    t0 = time.time()
    seen = {"input_stall": 0, "sample": 0}

    def window_ms(key):
        vals = timings.get(key, [])[seen[key]:]
        seen[key] += len(vals)
        return vals, 1e3 * float(np.mean(vals)) if vals else 0.0

    def flush():
        nonlocal window_metrics, t0
        acc = _metric_zero(name)
        for m in window_metrics:
            acc = _metric_accumulate(name, acc, m.cpu().numpy())
        loss_v = float(last_loss)
        # the loop's device-to-host read: the window's metrics and loss
        devprof.count_d2h((window_metrics, last_loss))
        mv = _metric_value(name, acc)
        sps = len(window_metrics) / (time.time() - t0)
        stalls, stall_ms = window_ms("input_stall")
        _, sample_ms = window_ms("sample")
        stalled = sum(w > 1e-3 for w in stalls)
        history.append({"loss": loss_v, name: mv, "steps_per_sec": sps,
                        "input_stall_ms": stall_ms, "stalled_steps": stalled,
                        "sample_ms": sample_ms})
        say(f"step={steps_done} loss={loss_v:.4f} {name}={mv:.4f} "
            f"steps/s={sps:.2f} input_stall_ms={stall_ms:.3f} "
            f"stalled={stalled}/{len(window_metrics)} "
            f"sample_ms={sample_ms:.3f}")
        window_metrics = []
        t0 = time.time()

    if use_pipeline:
        batches = pipeline(
            lambda step: None if follower else model.sample_start(
                graph, source_fn(step)),
            finish_batch, num_steps - start_step, sampler_depth,
            start=start_step, worker_init=seed_worker, timings=timings,
            profile=phase_profile, record_sample=False)
    else:
        batches = prefetch(make_batch, num_steps - start_step,
                           prefetch_depth, prefetch_threads,
                           start=start_step, worker_init=seed_worker,
                           timings=timings, profile=phase_profile,
                           record_sample=False)
    profiler = None
    p0, p1 = profile_steps
    warm = 1 if p0 > 0 else 0
    t_step = time.perf_counter()
    for batch in batches:
        cur = steps_done  # the step's index, as the prefetch labels it
        if profile_dir and cur - start_step == p0 - warm:
            profiler = _start_profiler(profile_dir, dev, warm, p1 - p0)
            if not warm:
                _stamp_align()
        t_h2d = time.perf_counter()
        batch = _row_batch(mesh, batch)
        if model.device_sampling:
            batch = model.device_sample_batch(
                batch, _step_seed(seed, steps_done), dev)
        else:
            batch = base.to_device(batch, dev)
        devprof.count_h2d(batch)
        if phase_profile:
            record_phase("h2d", (time.perf_counter() - t_h2d) * 1e6,
                         step=cur)
        t_dev = time.perf_counter()
        last_loss, metric = step_fn(state, batch)
        if cur == start_step and devprof.devprof_enabled():
            cs = devprof.compile_summary()
            say(f"first step dispatched: {cs['compile_events']} compile(s) "
                f"(kernel builds and CUDA-graph captures), "
                f"{cs['compile_ms_total']:.0f} ms compile time")
        if phase_profile:
            _fence(last_loss)
            t_host = time.perf_counter()
            record_phase("device", (t_host - t_dev) * 1e6, step=cur)
        window_metrics.append(metric)
        steps_done += 1
        if step_hook is not None:
            step_hook(steps_done)
        if profiler is not None:
            done = steps_done - start_step
            if done == p1:
                _fence(last_loss)  # the recorded steps' device work
            profiler.step()
            if done == p0 and warm:
                _stamp_align()
            if done == p1:
                profiler.stop()
                profiler = None
                say(f"profiler trace written to {profile_dir}")
        if len(window_metrics) == log_every:
            flush()
        if ckpt and steps_done % checkpoint_every == 0:
            ckpt.save(steps_done, state, force=True)
        if phase_profile:
            now = time.perf_counter()
            record_phase("host", (now - t_host) * 1e6, step=cur)
            record_phase("step", (now - t_step) * 1e6, step=cur)
            t_step = now
    if window_metrics:  # the last, partial window
        flush()
    if profiler is not None:  # the run ended inside the capture
        _fence(last_loss)
        profiler.stop()
        say(f"profiler trace written to {profile_dir}")
    if ckpt:
        # a relaunch that resumed at num_steps ran nothing new: no save
        if steps_done > start_step and steps_done % checkpoint_every != 0:
            ckpt.save(steps_done, state, force=True)
        ckpt.close()
    return state, history


def make_scan_train(model, inner_steps: int, batch_size: int):
    """Fully-device training, ``inner_steps`` steps per call.

    Requires a device-sampling model (its consts carry the adjacency slabs
    and the ``roots`` sampler). Returns ``scan_fn(state, seed) -> (state,
    losses [inner_steps])``: roots are drawn on the device from a
    ``torch.Generator`` seeded with ``seed``, and step i's neighbor draws
    are keyed by the host integer ``seed * inner_steps + i``, so the loop
    never waits for the device. ``state`` is updated in place."""
    step = model.make_train_step()

    def scan_fn(state, seed: int):
        sampler = state["consts"]["roots"]
        gen = torch.Generator(device=sampler["ids"].device)
        gen.manual_seed(seed)
        losses = []
        for i in range(inner_steps):
            roots = device_graph.sample_node(sampler, batch_size,
                                             generator=gen)
            loss, _ = step(state, {"roots": roots,
                                   "seed": seed * inner_steps + i})
            losses.append(loss)
        return state, torch.stack(losses)

    return scan_fn


def evaluate(model, graph, source_iter, state, device=None, seed: int = 0,
             log_fn=None, mesh=None) -> dict:
    """Streaming evaluation over an iterator of batches of model inputs
    (root ids, or a structured item such as LasGNN's ``{"label",
    "groups"}``), on one device (the card unless ``"cpu"`` is asked for),
    where ``state`` must live: batch i is ``model.device_sample_batch(
    item, seed + i)``, or for a host-sampling model ``model.sample(graph,
    item)`` uploaded, run through ``model.make_eval_step()``. f1
    accumulates its [tp, fp, fn] counts over the batches and auc its
    score histograms, any other metric (mrr) a running mean of the batch
    values. Returns ``{metric_name: value, "loss": mean batch loss}`` and
    passes ``"eval: {...}"`` to ``log_fn`` when given.

    Under a ``mesh`` every rank iterates the same global batches and
    evaluates its data row's contiguous slice of each (a batch that does
    not divide raises); the losses and metrics are reduced over the
    ranks, so every rank returns the global result (``state`` is the
    rank's sharded one)."""
    from euler_tpu_torch.parallel.mesh import shard_batch

    name = model.metric_name
    dev = resolve_device(device if mesh is None or mesh.device is None
                         else mesh.device)
    eval_fn = model.make_eval_step()
    scale = None if mesh is None else mesh.loss_scale(model.batch_loss)
    acc = _metric_zero(name)
    losses = []
    for i, ids in enumerate(source_iter):
        if mesh is not None:
            n = len(base.batch_leaves(ids)[0][1]) if isinstance(
                ids, dict) else len(ids)
            ids = shard_batch(ids, mesh, n)  # raises unless n divides
        if model.device_sampling:
            batch = model.device_sample_batch(ids, seed + i, device=dev)
        else:
            batch = base.to_device(_row_batch(
                mesh, None if _follower(mesh) else model.sample(graph, ids)),
                dev)
        loss, metric = eval_fn(state, batch)
        if mesh is not None:
            loss = mesh.reduce_loss(loss, scale)
            metric = mesh.reduce_metric(name, metric)
        acc = _metric_accumulate(name, acc, metric.cpu().numpy())
        losses.append(float(loss))
    result = {name: _metric_value(name, acc), "loss": float(np.mean(losses))}
    if log_fn is not None and _leader(mesh):
        log_fn(f"eval: {result}")
    return result


def save_embedding(model, max_id: int, state, batch_size: int = 1024,
                   device=None, graph=None, mesh=None) -> np.ndarray:
    """The ``[max_id+1, dim]`` embeddings of ids 0..max_id, as a numpy
    array: ``model.make_embed_step()`` over chunks of ``batch_size`` ids
    (the last chunk padded with id 0 and cut), on ``device`` (the card
    unless ``"cpu"`` is asked for), where ``state`` must live. A
    host-sampling model samples each chunk from ``graph``.

    Under a ``mesh`` each rank embeds its data row's contiguous slice of
    every chunk and the slices are all-gathered, so every rank returns
    the whole matrix; a ``batch_size`` the data axis does not divide
    raises."""
    dev = resolve_device(device if mesh is None or mesh.device is None
                         else mesh.device)
    if mesh is not None:
        part = mesh.batch_slice(batch_size)
    embed = model.make_embed_step()
    ids = np.arange(max_id + 1, dtype=np.int64)
    padded = np.concatenate(
        [ids, np.zeros((-len(ids)) % batch_size, dtype=np.int64)])
    chunks = []
    for i in range(0, len(padded), batch_size):
        chunk = padded[i:i + batch_size]
        if mesh is None:
            kw = {} if model.device_sampling else {"graph": graph}
            chunks.append(embed(state, model.sample_embed(chunk, dev, **kw)))
            continue
        chunk = chunk[part]
        if model.device_sampling:
            batch = model.sample_embed(chunk, dev)
        else:
            batch = base.to_device(_row_batch(
                mesh, None if _follower(mesh)
                else model.sample_host_embed(graph, chunk)), dev)
        chunks.append(mesh.all_gather(embed(state, batch), "data"))
    return torch.cat(chunks).cpu().numpy()[:len(ids)]
