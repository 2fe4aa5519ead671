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

    engine = InferenceEngine(cfg)
    out = engine.predict(images_u8)          # (N,256,256,3) uint8 -> dict
    server = BatchingServer(engine)
    verts = server.submit(one_image_u8).result()["verts3d_left"]  # (778, 3)
"""

from __future__ import annotations

import copy
import itertools
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from renderih_tpu_torch.assets import Assets, load_assets
from renderih_tpu_torch.config import Config
from renderih_tpu_torch.models import init_model, model_call_kwargs
from renderih_tpu_torch.ops.image import normalize_imagenet
from renderih_tpu_torch.parallel.mesh import Mesh, gather, split_batch
from renderih_tpu_torch.utils import trace

DEFAULT_BUCKETS = (1, 8, 32, 128)
_ROWS = trace.counter("engine.rows")          # real rows of every forward of `predict`
_PAD_ROWS = trace.counter("engine.pad_rows")  # and the rows padding them to the bucket


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

    def _forward(self, img_u8: np.ndarray) -> dict:
        """`img_u8` padded up to its bucket with copies of its last image,
        the bucket's slices on the mesh's devices (every forward queued
        before any is gathered), gathered in order on the first device."""
        with trace.span("engine.upload"):
            b = self._bucket(len(img_u8))
            if len(img_u8) < b:
                pad = np.repeat(img_u8[-1:], b - len(img_u8), axis=0)
                img_u8 = np.concatenate([img_u8, pad], axis=0)
            parts = split_batch(self.mesh, torch.from_numpy(np.ascontiguousarray(img_u8)))
        with trace.span("engine.forward"), torch.inference_mode():
            outs = [model(normalize_imagenet(x.float() / 255.0), **kwargs)
                    for (model, kwargs), x in zip(self._replicas, parts)]
            return {f"{key}_{hand}": gather([getattr(o, key)[hand] for o in outs], self.device)
                    for key in ("verts3d", "verts2d", "scale", "trans2d")
                    for hand in ("left", "right")}

    def warmup(self) -> None:
        """Run every bucket once (first-request latency -> steady state)."""
        size = self.cfg.model.img_size
        for b in self.buckets:
            out = self._forward(np.zeros((b, size, size, 3), np.uint8))
            next(iter(out.values())).cpu()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, images_u8: np.ndarray) -> dict:
        """images_u8: (N, H, W, 3) uint8 -> dict of numpy outputs, length N.

        Chunk i+1 is queued on the device before chunk i's results are
        copied back, so the copy overlaps the next chunk's compute.
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
                return self._forward(images_u8[start:start + take]), take

            outs: list[dict] = []
            pending, take = dispatch(0)
            start = take
            while True:
                nxt = dispatch(start) if start < n else None
                with trace.span("engine.copy_back"):
                    outs.append({k: v[:take].cpu().numpy() for k, v in pending.items()})
                if nxt is None:
                    break
                pending, take = nxt
                start += take
            with trace.span("engine.concat"):
                return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


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
