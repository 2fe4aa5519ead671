"""Serving engine: bucketed-batch two-hand inference + dynamic batching
(counterpart of `renderih_tpu/serve.py`).

  * `InferenceEngine` — runs the flagship forward on the card in batch
    buckets: each request chunk is padded up to the smallest covering
    bucket (the largest if none covers it), uploaded as uint8 and
    normalised on the device; outputs come back as numpy in mesh-vertex
    order. Weights come from a `state_dict` (upstream torch layout, e.g.
    `utils/weights.py:state_dict_from_jax`), from a training checkpoint
    directory (`checkpoint`, see `train/state.py`) or are drawn from a seed.
  * `BatchingServer` — a thread-safe dynamic batcher on top: concurrent
    `submit()` calls are coalesced for up to `max_wait_ms` and run as one
    padded device batch; callers get futures.

`decoder_bf16=True` runs the decoder trunk in bf16 (the engine's own copy
of the config gets `model.decoder_f32 = False`; JAX's serving knob,
`renderih_tpu/serve.py:55-64`): more throughput, not prediction-exact
(`tools/validate_bf16_decoder.py` measures how far trained predictions
move). The engine runs on the card (`device=None` means `cuda`) and raises
where there is none; pass `device="cpu"` to run the plain versions on the CPU.
With a mesh (`parallel/mesh.py`; JAX's `mesh=`, `renderih_tpu/serve.py:
67-72,109-122`) every bucket is rounded up to a multiple of the data
axis, the weights are replicated on each of its devices, and each bucket
runs split over them, one contiguous slice a device, gathered in order on
the first.

CUDA graphs. On the card the engine replays, for each bucket, one
captured CUDA graph per model part in place of launching the part's
kernels from Python: the `forward` of `encoder`, `mid_model` and `decoder`
on each replica (`GRAPHED_PARTS`) and, for a ViT, the wrapper's pyramid
head `vit_head` (`GRAPHED_METHODS`: the stride-8 patch embedding, the
nearest-2x add, `conv1` and `downsample`, a method of the model itself,
whose top level holds those modules under their upstream names), so that
every kernel of the forward but the input's normalisation and the casts
between the parts sits in a graph. The model's own `__call__` is left alone, so
forward hooks on the model or on a part, registered before or after a
capture, fire on every call with the live arguments and results. A part's
graph is keyed by what its call's flattened arguments show: each tensor's
shape, strides, dtype and device, every other argument (`n_levels`, a
`None` bbox), the structure, and whether inference mode is on. The engine
captures every bucket before it is returned, so no capture ever runs
beside a caller's thread: each key runs once eagerly on the engine's own
capture stream (the warm-up cuBLAS and cuDNN need there), is captured
there in thread-local mode (a thread serving another engine on the card
may allocate meanwhile), and the eager run's answer is copied into the
graph's static outputs. Python's cyclic collector is held off through
every capture (`_collector_paused`): a graphed part and its method form a
cycle, so a dropped engine's graphs wait for a collection, and one that
frees them inside a capture invalidates the capture. The stream is the
engine's alone because cuBLAS keeps one workspace for each thread's handle
and stream, and every graph captured there reads and writes it: on a
shared stream another engine's warm-up or replays would race this
engine's replays on it. cuBLAS keeps
that workspace, about 35 MB, for the life of the process; the streams come
from PyTorch's pool, 32 a card, which bounds how many there are, and a
33rd live engine on one card would share the first one's. A later call
whose key has no graph, or in training mode or with grad enabled, runs
eagerly. The graphs of a device share one memory pool,
captured in call order. What the model's code reads at capture is frozen
into the graphs: the TF32 and cuDNN flags, and Python-level patches of its
functions; `ungraph(engine)` puts the eager parts back for code that
patches them or hooks the parts' inner modules between calls. Arguments
are copied into the graph's static inputs (strides kept, so channels-last
stays channels-last), except where an argument already is that buffer:
another graph's static output, as the encoder's pyramid is the mid model's
input. B1's and B2's launches sit inside the graphs; their launch counters
(`kernels/_build.py:LaunchCounter`) count what the device ran: a capture's
Python calls are held back (`trace.hold`) and each replay adds them. The
counters `engine.graph_captures`, `engine.graph_replays` and
`engine.eager_forwards` (the part-calls run eagerly on the card, a
capture's warm-up run included) give the graphs' hit share. The eight
outputs of a forward are copied out of the decoder graph's static outputs
before another replay can be queued (`predict` queues chunk i+1 before
chunk i's copy back), and one lock per engine (`lock`) covers a forward's
replays and that copy: the batcher's thread and a caller's may share an
engine; whoever calls `engine.model` directly holds `engine.lock` around
the call and copies what it keeps. The graphs read the parameters where
they are, so weights loaded in place (`engine.model.load_state_dict`) keep
them valid; moving the model (`.to`) or assigning new parameter tensors
does not. On the CPU nothing of this runs.

Transfers. On the card a chunk goes in and out through one of two staging
slots (`_Transfers`, `_Slot`), each sized to the largest bucket (a bucket
uses a prefix): pinned host images, their device copy (on a mesh, each
device's contiguous slice) and pinned host outputs. The chunk is copied
into its slot's pinned images (the rows past it filled there with its last
image) once the slot's previous upload is done, and uploaded on an upload
stream of the device's own, which the device's current stream waits for
before it normalises; the upload waits for the slot's previous forward to
be queued. The forward runs on the current stream (forward hooks see its
live tensors), and `predict` queues the copy of `_forward`'s eight
outputs, whatever it returned, into the slot's pinned outputs on a
copy-back stream that waits for the current stream (the tensors are held
for it with `record_stream`); the upload and copy-back streams are
separate, so an upload never queues behind a copy back, and thus behind
the forward it waits for. Nothing between queuing chunk i and queuing
chunk i+1 waits for chunk i: chunk i+1 crosses to the card while chunk i
runs, and the host waits for chunk i's copy, then copies its rows into
the call's own result arrays, while chunk i+1 runs. No array returned
aliases a slot. One `predict` at a time moves data through an engine's
slots: it holds `_transfer_lock` for the whole call (as `warmup` does),
so two calls in flight never share a slot. The counters
`engine.staged_chunks` (chunks uploaded through a slot) and
`engine.overlapped_uploads` (of them, those issued while the last
forward was still running, read by `Event.query()`) give the overlap
share. On the CPU `from_numpy` and `.numpy()` share memory with the
arrays, and none of this runs.

    engine = InferenceEngine(cfg)
    out = engine.predict(images_u8)          # (N,256,256,3) uint8 -> dict
    server = BatchingServer(engine)
    verts = server.submit(one_image_u8).result()["verts3d_left"]  # (778, 3)
"""

from __future__ import annotations

import contextlib
import copy
import gc
import itertools
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from renderih_tpu_torch.assets import Assets, load_assets
from renderih_tpu_torch.config import Config
from renderih_tpu_torch.models import init_model, model_call_kwargs
from renderih_tpu_torch.ops.image import normalize_imagenet
from renderih_tpu_torch.parallel.mesh import Mesh, gather, split_batch
from renderih_tpu_torch.utils import trace

DEFAULT_BUCKETS = (1, 8, 32, 128)
_ROWS = trace.counter("engine.rows")          # real rows of every forward of `predict`
_PAD_ROWS = trace.counter("engine.pad_rows")  # and the rows padding them to the bucket
_CAPTURES = trace.counter("engine.graph_captures")  # CUDA graphs captured, one a part and key
_REPLAYS = trace.counter("engine.graph_replays")    # part-calls replayed from a graph
_EAGER = trace.counter("engine.eager_forwards")     # part-calls run eagerly on the card
_STAGED = trace.counter("engine.staged_chunks")     # chunks uploaded through a staging slot
_OVERLAPPED = trace.counter("engine.overlapped_uploads")  # of them, while the last forward ran
GRAPHED_PARTS = ("encoder", "mid_model", "decoder")
GRAPHED_METHODS = ("vit_head",)  # methods of a ViT model itself


def _graphed_calls(model: torch.nn.Module) -> list:
    """(owner, attribute) of each call of `model` that the engine graphs."""
    return ([(getattr(model, name), "forward") for name in GRAPHED_PARTS]
            + [(model, name) for name in GRAPHED_METHODS if model.vit])


def resolve_device(device: torch.device | str | None) -> torch.device:
    """`None` means the card; asking for the card where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' to run its plain versions on the CPU")
    return dev


def replicate(model: torch.nn.Module, devices: list) -> list:
    """`model` on each of `devices`: itself on the first, which must be
    where it is, and a copy on each of the others."""
    on, first = next(model.parameters()).device, torch.device(devices[0])
    if on.type != first.type or first.index not in (None, on.index):
        raise ValueError(f"the model is on {on}, the mesh's first device is {first}")
    return [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]


class InferenceEngine:
    """Bucketed-batch inference over the flagship model."""

    def __init__(
        self,
        cfg: Config | None = None,
        assets: Assets | None = None,
        state_dict: dict | None = None,
        buckets: tuple = DEFAULT_BUCKETS,
        device: torch.device | str | None = None,
        seed: int = 0,
        checkpoint: str | None = None,
        mesh: Mesh | None = None,
        decoder_bf16: bool = False,
    ):
        # own copy: never mutate a caller's Config
        self.cfg = copy.deepcopy(cfg) if cfg is not None else Config()
        if decoder_bf16:
            self.cfg.model.decoder_f32 = False
        self.buckets = tuple(sorted(buckets))
        if mesh is not None:
            want, first = torch.device(device or mesh.devices[0]), mesh.devices[0]
            if want.type != first.type or want.index not in (None, first.index):
                raise ValueError(f"device {device} is not the mesh's first {first}")
            device = mesh.devices[0]
            # as JAX's sharded forward needs: batches divisible by the data axis
            n = mesh.n_data
            self.buckets = tuple(sorted({-(-b // n) * n for b in self.buckets}))
        self.device = resolve_device(device)
        # without a mesh, one of this device: one replica, the bucket whole
        self.mesh = mesh if mesh is not None else Mesh((self.device,))
        self.assets = assets if assets is not None else load_assets(self.cfg.assets)
        model = init_model(self.cfg, self.assets,
                           torch.Generator().manual_seed(seed))
        if checkpoint is not None:
            if state_dict is not None:
                raise ValueError("pass a state_dict or a checkpoint, not both")
            from renderih_tpu_torch.train.state import checkpoint_state_dict

            state_dict = checkpoint_state_dict(checkpoint)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self._replicas = [(r, model_call_kwargs(self.assets, d)) for d, r in
                          zip(self.mesh.devices, replicate(self.model, self.mesh.devices))]
        self.lock = threading.Lock()
        self._graphs: list = []
        self._transfers = None  # on the CPU `from_numpy` and `.numpy()` copy nothing
        self._transfer_lock = contextlib.nullcontext()
        if self.device.type == "cuda":
            self._transfers = _Transfers(self.mesh.devices, self.buckets[-1])
            self._transfer_lock = threading.Lock()
            self._capture_graphs()

    def _capture_graphs(self) -> None:
        """Graph the parts of every replica and capture every bucket, before
        any other thread can reach the engine (module docstring)."""
        self._graphs = [_DeviceGraphs(torch.device(d)) for d in self.mesh.devices]
        for (replica, _), graphs in zip(self._replicas, self._graphs):
            for owner, attr in _graphed_calls(replica):
                graphs.install(owner, attr)
            graphs.capturing = True
        try:
            self.warmup()
        finally:
            for graphs in self._graphs:
                graphs.capturing = False

    def _forward(self, img_u8: np.ndarray) -> dict:
        """`img_u8` padded up to its bucket with copies of its last image,
        the bucket's slices on the mesh's devices (every forward queued
        before any is gathered), gathered in order on the first device. On
        the card the images go through the staging slot of the chunk in
        flight, and the caller holds `_transfer_lock` (`predict`, `warmup`)."""
        with trace.span("engine.upload"):
            b = self._bucket(len(img_u8))
            if self._transfers is not None:
                parts = self._transfers.stage(img_u8, b)
            else:
                if len(img_u8) < b:
                    pad = np.repeat(img_u8[-1:], b - len(img_u8), axis=0)
                    img_u8 = np.concatenate([img_u8, pad], axis=0)
                parts = split_batch(self.mesh, torch.from_numpy(np.ascontiguousarray(img_u8)))
        with trace.span("engine.forward"), torch.inference_mode(), self.lock:
            outs = [model(normalize_imagenet(x.float() / 255.0), **kwargs)
                    for (model, kwargs), x in zip(self._replicas, parts)]
            if self._transfers is not None:
                self._transfers.forwarded()
            out = {f"{key}_{hand}": gather([getattr(o, key)[hand] for o in outs], self.device)
                   for key in ("verts3d", "verts2d", "scale", "trans2d")
                   for hand in ("left", "right")}
            # out of the decoder graph's static outputs before the next replay
            return {k: v.clone() for k, v in out.items()} if self._graphs else out

    def warmup(self) -> None:
        """Run every bucket once (first-request latency -> steady state)."""
        size = self.cfg.model.img_size
        with self._transfer_lock:
            for b in self.buckets:
                out = self._forward(np.zeros((b, size, size, 3), np.uint8))
                next(iter(out.values())).cpu()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, images_u8: np.ndarray) -> dict:
        """images_u8: (N, H, W, 3) uint8 -> dict of numpy outputs, length N,
        arrays of this call's own.

        Chunk i+1 is queued on the device before the host waits for chunk
        i's results; on the card chunk i+1's upload then overlaps chunk i's
        forward, and chunk i's copy into the result overlaps chunk i+1's
        forward (module docstring).
        """
        with trace.span("engine.predict"):
            images_u8 = np.asarray(images_u8)
            n = len(images_u8)
            if n == 0:
                raise ValueError("predict needs at least one image")

            def dispatch(start: int):
                b = self._bucket(n - start)
                take = min(n - start, b)
                _ROWS.add(take)
                _PAD_ROWS.add(b - take)
                out = self._forward(images_u8[start:start + take])
                if self._transfers is not None:
                    return start, take, self._transfers.copy_back(out, take)
                return start, take, lambda: {k: v[:take].cpu().numpy() for k, v in out.items()}

            result: dict = {}
            with self._transfer_lock:
                pending = dispatch(0)
                while pending is not None:
                    start, take, fetch = pending
                    end = start + take
                    pending = dispatch(end) if end < n else None
                    with trace.span("engine.copy_back"):
                        for k, v in fetch().items():
                            if k not in result:
                                result[k] = np.empty((n, *v.shape[1:]), v.dtype)
                            result[k][start:end] = v
            return result


class _Slot:
    """A staging slot of `_Transfers`: pinned host images and their copy on
    each device of the mesh (a contiguous slice each), made at the first
    chunk of their image shape; pinned host outputs, made at a key's first
    copy back; and the events that order their reuse."""

    def __init__(self, devices: tuple, rows: int):
        self.devices, self.rows = devices, rows
        self.pinned, self.images = None, None  # (rows, H, W, 3) uint8, and as numpy
        self.on_device: list = []               # (rows / n, H, W, 3) uint8 on each device
        self.outputs: dict = {}                 # key -> pinned (rows, ...)
        self.uploaded = [torch.cuda.Event() for _ in devices]  # upload stream: H2D done
        self.consumed = [torch.cuda.Event() for _ in devices]  # compute: forward queued
        self.copied = torch.cuda.Event()                        # copy-back stream: D2H done

    def allocate(self, shape: tuple) -> None:
        for ev in self.consumed:
            ev.synchronize()
        self.pinned = torch.empty((self.rows, *shape), dtype=torch.uint8, pin_memory=True)
        self.images = self.pinned.numpy()
        per = self.rows // len(self.devices)
        self.on_device = [torch.empty((per, *shape), dtype=torch.uint8, device=d)
                          for d in self.devices]

    def output(self, key: str, v: torch.Tensor) -> torch.Tensor:
        if key not in self.outputs:
            self.outputs[key] = torch.empty((self.rows, *v.shape[1:]), dtype=v.dtype,
                                            pin_memory=True)
        return self.outputs[key]


class _Transfers:
    """The card's way in and out of an `InferenceEngine` (module docstring):
    two staging slots, the chunk in flight using `slots[turn]`; an upload
    stream on each mesh device and a copy-back stream on the first, both
    high priority, so from a pool apart from the capture streams'. Used
    under the engine's `_transfer_lock`."""

    def __init__(self, devices: tuple, rows: int):
        self.devices = devices
        self.slots = [_Slot(devices, rows) for _ in range(2)]
        self.turn = 0
        self.uploads = [torch.cuda.Stream(d, priority=-1) for d in devices]
        self.copies = torch.cuda.Stream(devices[0], priority=-1)
        self.last_forward = None  # the last forward's `consumed` event on the first device

    def stage(self, img_u8: np.ndarray, b: int) -> list:
        """`img_u8` and `b - len(img_u8)` copies of its last image in the
        slot's pinned images, a slice uploaded on each device's upload
        stream, which each device's current stream waits for: the slices."""
        slot, take = self.slots[self.turn], len(img_u8)
        for ev in slot.uploaded:
            ev.synchronize()  # the last upload from these pinned images is done
        if slot.images is None or slot.images.shape[1:] != img_u8.shape[1:]:
            slot.allocate(img_u8.shape[1:])
        np.copyto(slot.images[:take], img_u8)
        slot.images[take:b] = img_u8[-1]
        _STAGED.add()
        if self.last_forward is not None and not self.last_forward.query():
            _OVERLAPPED.add()
        step, parts = b // len(self.devices), []
        for i, (dev, stream) in enumerate(zip(self.devices, self.uploads)):
            x = slot.on_device[i][:step]
            with torch.cuda.stream(stream):
                stream.wait_event(slot.consumed[i])  # the last forward from x is queued
                x.copy_(slot.pinned[i * step:(i + 1) * step], non_blocking=True)
                slot.uploaded[i].record(stream)
            torch.cuda.current_stream(dev).wait_event(slot.uploaded[i])
            parts.append(x)
        return parts

    def forwarded(self) -> None:
        """Mark on each device's current stream that the chunk in flight's
        forward, which reads the slot's device images first, is queued."""
        slot = self.slots[self.turn]
        for ev, dev in zip(slot.consumed, self.devices):
            ev.record(torch.cuda.current_stream(dev))
        self.last_forward = slot.consumed[0]

    def copy_back(self, out: dict, take: int):
        """The first `take` rows of each of `out`'s tensors queued into the
        slot's pinned outputs on the copy-back stream, behind all that the
        first device's current stream holds; the turn passes to the other
        slot. A function that waits for the copies and returns those rows
        as numpy views of the pinned outputs."""
        slot = self.slots[self.turn]
        self.turn ^= 1
        self.copies.wait_stream(torch.cuda.current_stream(self.devices[0]))
        with torch.cuda.stream(self.copies):
            for key, v in out.items():
                v.record_stream(self.copies)  # not reused before the copy is done
                slot.output(key, v)[:take].copy_(v[:take], non_blocking=True)
            slot.copied.record(self.copies)

        def fetch() -> dict:
            slot.copied.synchronize()
            return {key: slot.outputs[key][:take].numpy() for key in out}

        return fetch


def _key_of(leaf):
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.stride(), leaf.dtype, leaf.device)
    return leaf


class _Graph:
    """One captured call of a part: its static inputs and outputs, and the
    counts its capture held back, added at each replay."""

    def __init__(self, graph, inputs: list, outputs: list, spec, held: list):
        self.graph, self.inputs, self.outputs, self.spec = graph, inputs, outputs, spec
        totals: dict = {}
        for counter, n in held:
            totals[counter] = totals.get(counter, 0) + n
        self.counts = tuple(totals.items())

    def replay(self, leaves: list):
        for static, x in zip(self.inputs, leaves):
            if isinstance(static, torch.Tensor) and static is not x:
                static.copy_(x)
        self.graph.replay()
        for counter, n in self.counts:
            counter.add(n)
        _REPLAYS.add()
        return tree_unflatten(self.outputs, self.spec)


_PAUSE = threading.Lock()
_paused = [0, False]  # captures in flight in the process; the collector was on before them


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic collector off until the last capture in flight ends
    (module docstring), then as it was."""
    with _PAUSE:
        if _paused[0] == 0:
            _paused[1] = gc.isenabled()
            gc.disable()
        _paused[0] += 1
    try:
        yield
    finally:
        with _PAUSE:
            _paused[0] -= 1
            if _paused[0] == 0 and _paused[1]:
                gc.enable()


class _DeviceGraphs:
    """The CUDA graphs of an engine's parts on one device (module docstring):
    the engine's own capture stream, one memory pool, and every graph's
    static outputs. Keys without a graph are captured only while
    `capturing` is set."""

    def __init__(self, device: torch.device):
        self.device, self.capturing = device, False
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream()
            self.pool = torch.cuda.graph_pool_handle()
        self.owned: dict = {}  # id -> static output tensor of a graph here

    def install(self, module: torch.nn.Module, attr: str = "forward") -> None:
        """Put the graphed call in place of `module`'s method `attr`."""
        eager, graphs = getattr(module, attr), {}

        def call(*args, **kwargs):
            graph = None
            if not (module.training or torch.is_grad_enabled()):
                leaves, spec = tree_flatten((args, kwargs))
                key = (str(spec), torch.is_inference_mode_enabled(), *map(_key_of, leaves))
                graph = graphs.get(key)
                if graph is None and self.capturing:
                    graph, out = self._capture(eager, leaves, spec)
                    graphs[key] = graph
                    return out
            if graph is None:
                _EAGER.add()
                return eager(*args, **kwargs)
            with torch.cuda.device(self.device):
                return graph.replay(leaves)

        setattr(module, attr, call)

    def _capture(self, fn, leaves: list, spec) -> tuple:
        """`fn` on `leaves` once eagerly on the capture stream, ordered with
        the current one, then captured there: (the graph, its static outputs
        holding the eager run's answer)."""
        inputs = [x if not isinstance(x, torch.Tensor) or self.owned.get(id(x)) is x
                  else torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
                  for x in leaves]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                _EAGER.add()
                args, kwargs = tree_unflatten(leaves, spec)
                answer = tree_flatten(fn(*args, **kwargs))[0]
            args, kwargs = tree_unflatten(inputs, spec)
            with _collector_paused(), trace.hold() as held, torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream, capture_error_mode="thread_local"):
                out = fn(*args, **kwargs)
            outputs, out_spec = tree_flatten(out)
            with torch.cuda.stream(self.stream):
                for static, x in zip(outputs, answer):
                    if isinstance(static, torch.Tensor):
                        static.copy_(x)
            current.wait_stream(self.stream)
        self.owned.update((id(t), t) for t in outputs if isinstance(t, torch.Tensor))
        _CAPTURES.add()
        return _Graph(graph, inputs, outputs, out_spec, held), out


def ungraph(engine: InferenceEngine) -> None:
    """Put back the eager `forward` of every graphed part of `engine`, its
    graphs dropped: for code that patches the model's functions or hooks
    the parts' inner modules between calls, which a replay would not see."""
    for replica, _ in engine._replicas:
        for owner, attr in _graphed_calls(replica):
            vars(owner).pop(attr, None)
    engine._graphs = []


class BatchingServer:
    """Dynamic batcher: coalesces concurrent single-image requests."""

    def __init__(self, engine: InferenceEngine, max_batch: int | None = None,
                 max_wait_ms: float = 2.0):
        self.engine = engine
        self.max_batch = max_batch or engine.buckets[-1]
        self.max_wait_s = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._rids = itertools.count()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image_u8: np.ndarray) -> Future:
        """image_u8: (H, W, 3) uint8. Resolves to the per-image output dict."""
        if self._stop.is_set():
            raise RuntimeError("server closed")
        fut: Future = Future()
        # the queue wait's span, None unless tracing is on
        self._q.put((image_u8, fut, trace.begin("serve.queue", next(self._rids))))
        return fut

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        # fail any request the worker never picked up, so no caller blocks
        while True:
            try:
                _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("server closed"))

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                with trace.span("serve.idle"):
                    first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            with trace.span("serve.batch"):
                try:
                    with trace.span("serve.coalesce"):
                        trace.end(first[2])
                        t0 = time.perf_counter()
                        while len(batch) < self.max_batch:
                            left = self.max_wait_s - (time.perf_counter() - t0)
                            if left <= 0:
                                break
                            try:
                                item = self._q.get(timeout=left)
                            except queue.Empty:
                                break
                            trace.end(item[2])
                            batch.append(item)
                        images = np.stack([b[0] for b in batch])
                    out = self.engine.predict(images)
                    with trace.span("serve.fanout"):
                        for i, (_, fut, _) in enumerate(batch):
                            fut.set_result({k: v[i] for k, v in out.items()})
                except Exception as e:  # the worker keeps serving; waiters see it
                    for _, fut, _ in batch:
                        if not fut.done():
                            fut.set_exception(e)
