"""One cell's inputs, the program built on them, and the check of its outputs.

Everything a run feeds the program comes from `--seed` through this module,
on the device: the weights (`cardbench/reference/weights.py`, upstream layout),
each hand's positional encoding at the coarsest graph level, and a pool of
uint8 images. The reference gets the same. From the program the benchmark
takes only the system under test (`InferenceEngine` on the port's `Config`),
and the graph topology of its deterministic synthetic assets, whose node
counts the configuration file states.

The check has two stages. End to end, a seeded sample of the window's outputs
against the reference run from the same images (`compare`). At the decoder,
a seeded sample of the window's decoder calls (`DecoderCapture`): the
program's decoder outputs against the reference's decoder run on the inputs
the program's decoder got (`decoder_number`), so that the decoder's own
precision is held apart from the bfloat16 encoder's noise.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from cardbench.reference.weights import draw_state_dict

ROOT = Path(__file__).resolve().parents[2]  # the checkout
CARDBENCH = ROOT / "cardbench"
# sub-seeds of one run, derived from --seed
WEIGHTS, POSITIONAL, IMAGES, TRAFFIC, SAMPLE, DECODER = range(6)
# the configuration file's keys that are the port's `ModelConfig` fields
MODEL_FIELDS = ("encoder", "img_size", "deconv_dims", "img_dims", "gcn_in_dims", "gcn_out_dims",
                "graph_layer_num", "num_attn_heads", "grid_size")
OUTPUT_KEYS = ("verts3d", "verts2d", "scale", "trans2d")  # the engine's, each `_left`/`_right`
HANDS = ("left", "right")
STATS = ("max_abs", "worst_image", "rel_l2")
# the outputs compared and the statistic each is compared by (PERF.md, section 2:
# verts2d and scale read no control three times their program readings)
CHECKED = {"verts3d": "worst_image", "trans2d": "rel_l2"}
# the decoder's own check (`decoder_ratio`): the statistic of `gap_stats` it
# compares; how many of the window's decoder calls are kept, and rows of each
DECODER_STAT, DECODER_CALLS, DECODER_ROWS = "worst_image", 8, 16
# (encoder, decoder) precision -> the port's (train.precision, model.decoder_f32);
# float32 throughout is what `tests/test_cardbench_reference.py` holds the reference to
PRECISION = {("bfloat16", "float32"): ("bf16", True), ("float32", "float32"): ("f32", True)}


def sub_seed(seed: int, which: int) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    ss = np.random.SeedSequence([seed % 2 ** 64, which])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reference_of(config: dict):
    """The plain reference module a configuration names (`reference`, a module
    of `cardbench/reference/`): it provides `build(config, device)` (the network,
    parameters empty, upstream state-dict layout, `forward(uint8 images, pe_left,
    pe_right)` -> the engine's outputs), `Precision`, and the kernel sites
    `BlockConv3x3` and `AttentionCore` that `harness/work.py` counts."""
    return importlib.import_module(f"cardbench.reference.{config['reference']}")


class Cell:
    """A cell of `BENCHMARK.json` with its configuration and traffic files."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", config: dict | None = None, traffic: dict | None = None):
        bench = load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload} in BENCHMARK.json")
        self.bench, self.entry = bench, cells[workload]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = config or load_json(ROOT / conf["file"])
        self.traffic = traffic or load_json(CARDBENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.reference = reference_of(self.config)
        self._pool = None
        # PyTorch lets cuDNN run float32 convolutions in TF32 unless told not to;
        # a float32 decoder is run with that off (PERF.md, section 2)
        self.torch_tf32_default = False

    # -- inputs -----------------------------------------------------------
    def generator(self, which: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, which))

    def state_dict(self) -> dict:
        """The weights, drawn on the device in float32 (the program keeps its
        parameters in float32 and casts per part)."""
        return draw_state_dict(self.reference.build(self.config, "meta"),
                               sub_seed(self.seed, WEIGHTS), self.device)

    def positional(self) -> tuple:
        """Each hand's (V, 3) positional encoding in [-1, 1], V the coarsest level."""
        g = self.generator(POSITIONAL)
        v = self.config["verts_nums"][0]
        return tuple(torch.rand(v, 3, generator=g, device=self.device) * 2 - 1 for _ in range(2))

    def pool(self) -> np.ndarray:
        """The traffic's image pool, (P, S, S, 3) uint8 on the host."""
        if self._pool is None:
            size = self.config["img_size"]
            g = self.generator(IMAGES)
            imgs = torch.randint(0, 256, (self.traffic["pool_images"], size, size, 3),
                                 generator=g, device=self.device, dtype=torch.uint8)
            self._pool = imgs.cpu().numpy()
        return self._pool

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def rng(self, which: int) -> np.random.Generator:
        return np.random.default_rng(sub_seed(self.seed, which))

    # -- the program ------------------------------------------------------
    def port_config(self):
        from renderih_tpu_torch.config import Config

        cfg = Config()
        for key in MODEL_FIELDS:
            value = self.config[key]
            setattr(cfg.model, key, tuple(value) if isinstance(value, list) else value)
        prec = self.config["precision"]
        cfg.train.precision, cfg.model.decoder_f32 = PRECISION[(prec["encoder"], prec["decoder"])]
        return cfg

    def port_assets(self):
        """The port's synthetic asset bundle with this run's positional encoding."""
        from renderih_tpu_torch.assets import Assets, make_synthetic_assets

        assets = make_synthetic_assets(0)
        if list(assets.left.verts_nums) != list(self.config["verts_nums"]):
            raise SystemExit(f"the assets coarsen to {assets.left.verts_nums}, the "
                             f"configuration states {self.config['verts_nums']}")
        pe_left, pe_right = (p.cpu() for p in self.positional())
        return Assets(left=dataclasses.replace(assets.left, pe=pe_left),
                      right=dataclasses.replace(assets.right, pe=pe_right))

    def engine(self):
        from renderih_tpu_torch.serve import InferenceEngine

        if self.config["precision"]["decoder"] == "float32" and not self.torch_tf32_default:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        return InferenceEngine(self.port_config(), assets=self.port_assets(),
                               state_dict=self.state_dict(),
                               buckets=tuple(self.traffic["buckets"]), device=self.device)

    def decoder_capture(self, model):
        """A `DecoderCapture` on the program's decoder for the measured window."""
        from cardbench.harness.hooks import DecoderCapture

        return DecoderCapture(model.decoder, self.rng(DECODER), DECODER_CALLS, DECODER_ROWS)

    # -- the check --------------------------------------------------------
    def reference_outputs(self, rows: np.ndarray, precision=None, block: int = 64) -> dict:
        """The reference's outputs for pool rows `rows`, computed in blocks."""
        ref = self.reference.build(self.config, self.device)
        ref.load_state_dict(self.state_dict())
        if precision is not None:
            ref.set_precision(precision)
        pe_left, pe_right = self.positional()
        pool, outs = self.pool(), []
        with torch.no_grad():
            for i in range(0, len(rows), block):
                img = torch.from_numpy(pool[rows[i:i + block]]).to(self.device)
                out = ref(img, pe_left, pe_right)
                outs.append({k: v.double().cpu().numpy() for k, v in out.items()})
        del ref
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def stated_precision(self):
        """The reference's `Precision` of the configuration's own precision."""
        prec = self.config["precision"]
        return self.reference.Precision(encoder=prec["encoder"], decoder=prec["decoder"])

    def yardstick(self, rows: np.ndarray) -> tuple:
        """(the float32 reference's outputs for pool rows `rows`, the gaps to them
        of the reference computed in the configuration's precision)."""
        ref32 = self.reference_outputs(rows)
        return ref32, gap_stats(self.reference_outputs(rows, self.stated_precision()), ref32)

    def compare(self, rows: np.ndarray, got: dict) -> dict:
        """{output: number} of `CHECKED` for the program's outputs `got` for pool
        rows `rows` (`numbers`); every statistic's raw gaps go on an earlier line."""
        ref32, stated = self.yardstick(rows)
        program = gap_stats(got, ref32)
        print("gaps to the float32 reference: program " + json.dumps(program)
              + "; reference in the stated precision " + json.dumps(stated))
        return numbers(program, stated)

    def decoder_gaps(self, kept: list, precision=None) -> tuple:
        """(`gap_stats` of the program's decoder outputs in `kept` (a
        `DecoderCapture`'s) to the reference's decoder run on the same inputs in
        float64, the same of the reference's decoder in float32 with TF32 off).
        With `precision`, the reference's decoder in that precision stands in
        the program's place: the control."""
        if not kept:
            inf = {s: {k: float("inf") for k in OUTPUT_KEYS} for s in STATS}
            return inf, inf
        ref = self.reference.build(self.config, self.device)
        ref.load_state_dict(self.state_dict())
        ref64 = copy.deepcopy(ref).double()
        pe = self.positional()
        got, f32, want = [], [], []
        with torch.no_grad():
            for _, inputs, outputs in kept:
                g, fmaps = inputs["global"], inputs["fmaps"]
                want.append(ref64.decode(g.double(), [f.double() for f in fmaps],
                                         *(p.double() for p in pe)))
                f32.append(ref.decode(g, fmaps, *pe))
                if precision is not None:
                    ref.set_precision(precision)
                    outputs = ref.decode(g, fmaps, *pe)
                    ref.set_precision(self.reference.Precision())
                got.append(outputs)
        del ref, ref64
        cat = lambda outs: {k: torch.cat([o[k] for o in outs]).double().cpu().numpy()
                            for k in outs[0]}
        want = cat(want)
        return gap_stats(cat(got), want), gap_stats(cat(f32), want)

    def decoder_number(self, kept: list) -> float:
        """The decoder's number: for each output, the program's gap to the
        float64 reference decoder in units of the float32 reference decoder's
        gap to it (`DECODER_STAT`, on the same inputs); the largest over the four
        outputs. Every statistic's raw gaps go on an earlier line."""
        program, f32 = self.decoder_gaps(kept)
        print("decoder gaps to the float64 reference decoder on its own inputs: program "
              + json.dumps(program) + "; reference decoder in float32 " + json.dumps(f32))
        return decoder_ratio(program, f32)

    def judge(self, gaps: dict) -> tuple:
        """(correct, {output: {"value", "limit"}}) against the configuration's
        limits; an output without a limit fails."""
        limits = self.config.get("limits", {})
        checked = {k: {"value": v, "limit": limits.get(k)} for k, v in gaps.items()}
        return all(c["limit"] is not None and c["value"] <= c["limit"]
                   for c in checked.values()), checked


    def check(self, res: dict) -> tuple:
        """(correct, checked) of a kind's run: every sampled output within its
        limit of the reference, the kept decoder calls within theirs of the
        reference's decoder, and no request failed."""
        if not res["check_outputs"]:
            return False, {}
        gaps = self.compare(res["check_rows"], res["check_outputs"])
        gaps["decoder"] = self.decoder_number(res["decoder_kept"])
        ok, checked = self.judge(gaps)
        return ok and res["failed"] == 0, checked


def numbers(gaps: dict, stated: dict) -> dict:
    """The numbers compared: for each output of `CHECKED`, its statistic's gap to
    the float32 reference (`gaps`, from `gap_stats`) over the same statistic's
    gap of the reference computed in the configuration's precision (`stated`).
    A seed's random weights set how far the stated precision's rounding moves
    the outputs (ten times more on some seeds than on others); the number says
    how far the program moved them in units of that."""
    return {k: gaps[st][k] / stated[st][k] for k, st in CHECKED.items()}


def decoder_ratio(gaps: dict, f32: dict) -> float:
    """The largest over the outputs of `DECODER_STAT`'s gap over the float32
    reference decoder's. A seed's random weights set how far any rounding in
    the decoder moves its outputs; the number says how far the program moved
    them in units of float32's own rounding."""
    return max(gaps[DECODER_STAT][k] / max(f32[DECODER_STAT][k], 1e-300) for k in OUTPUT_KEYS)


def gap_stats(got: dict, want: dict) -> dict:
    """{statistic: {output: gap}}, each gap the larger over the two hands:
      * `max_abs`: max |got - want| over every value, over max |want|;
      * `worst_image`: the largest over images of ||got_i - want_i||_2, over the
        root mean square over images of ||want_i||_2;
      * `rel_l2`: ||got - want||_2 / ||want||_2 over the whole sample.
    An output of another shape, or not finite, reads inf."""
    out = {s: {} for s in STATS}
    for key in OUTPUT_KEYS:
        per = {s: [] for s in STATS}
        for hand in HANDS:
            w = want[f"{key}_{hand}"]
            g = np.asarray(got[f"{key}_{hand}"], np.float64)
            if g.shape != w.shape or not np.all(np.isfinite(g)):
                for s in STATS:
                    per[s].append(float("inf"))
                continue
            d, n = (g - w).reshape(len(w), -1), w.reshape(len(w), -1)
            per["max_abs"].append(float(np.abs(d).max() / max(np.abs(n).max(), 1e-30)))
            rms = max(float(np.sqrt(np.mean(np.sum(n * n, axis=1)))), 1e-30)
            per["worst_image"].append(float(np.sqrt(np.sum(d * d, axis=1)).max() / rms))
            per["rel_l2"].append(float(np.linalg.norm(d) / max(np.linalg.norm(n), 1e-30)))
        for s in STATS:
            out[s][key] = max(per[s])
    return out


@contextlib.contextmanager
def window_without_gc():
    """The measured window with Python's cyclic collector off (collected first):
    its pauses stop every thread of the process, the generator's included, and
    fall on the window at random. Reference counting still frees everything the
    window drops."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX package."""
    banned = {"jax", "jaxlib", "flax", "renderih_tpu"}
    return sorted({name.split(".")[0] for name in list(sys.modules)} & banned)
