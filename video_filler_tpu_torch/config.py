"""Experiment configuration for the PyTorch port.

The port's own copy of the JAX package's option table
(``video_filler_tpu/config.py``): the same fields, names, defaults, types
and order, the reference env-var / ``key=value`` semantics (``train.lua:35``:
number first, else the raw string) and the regime selector.  The port
imports nothing of the JAX package; tests/test_torch_imports.py holds the
copy to the original.  Field comments describe each option as the JAX
package defines it.

One field is the port's: ``device``.  The port never picks a device by
itself, and ``device=cuda`` on a machine without CUDA raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import torch

__all__ = ["Opt", "REGIMES", "from_args", "from_env", "resolve_device",
           "split_regime"]

_BOOL_WORDS = {"true": True, "false": False, "yes": True, "no": False,
               "on": True, "off": False}


def _coerce(raw: str, default: Any) -> Any:
    """Reference coercion order: number first, else raw string (train.lua:35).

    Two deliberate divergences, both loud: bool fields accept true/false
    words (the reference's `tonumber('false') or raw` stores the STRING,
    which is truthy — `conditionAdv=false` silently enabling the flag is a
    footgun we refuse to replicate), and malformed bool/int values raise
    ValueError (wrapped with the key name by the callers) instead of
    sliding through as a float or string."""
    if isinstance(default, bool):
        word = raw.strip().lower()
        if word in _BOOL_WORDS:
            return _BOOL_WORDS[word]
        try:
            return bool(float(raw))
        except ValueError:
            raise ValueError(f"expected a boolean (0/1/true/false), "
                             f"got {raw!r}")
    try:
        num = float(raw)
    except ValueError:
        return raw
    if isinstance(default, int):
        if not math.isfinite(num) or num != int(num):
            raise ValueError(f"expected an integer, got {raw!r}")
        return int(num)
    if isinstance(default, str):
        return raw
    return num


@dataclasses.dataclass
class Opt:
    """Unified config covering every reference entry script, plus the
    port's ``device``.

    Field names/defaults follow the reference opt tables:
    train.lua:6-34 (image CE), train_vid_weighted.lua:16-49 (video),
    train_wholeim_input.lua:35-73 (patch-array), train_logo_withmask.lua (pairs).
    """

    # --- core (train.lua:6-27) ---
    batchSize: int = 64
    loadSize: int = 350          # short-side resize; 0 = none; -1/-2 = random scale
    fineSize: int = 128          # random crop size
    nBottleneck: int = 100
    nef: int = 64
    ngf: int = 64
    ndf: int = 64
    nc: int = 3
    wtl2: float = 0.0            # reconstruction weight (0 = adversarial only)
    overlapPred: int = 0         # context ring inside the center hole
    nThreads: int = 4
    niter: int = 25
    lr: float = 2e-4
    beta1: float = 0.5
    ntrain: float = math.inf
    display: bool = True
    display_iter: int = 50
    display_id: int = 10       # accepted for reference-CLI compatibility
    display_port: int = 8000   # port for displayServer (display rock parity)
    displayServer: bool = False  # serve live loss curves + grids over HTTP
                                 # (utils/dashboard.py); PNG/JSONL dumps
                                 # happen regardless
    name: str = "train1"
    manualSeed: int = 0
    split: int = 100             # train percentage (dataset.lua:48; the
                                 # reference's donkey hardcodes 100 — all
                                 # data trains).  Folder dataset: per-class
                                 # permutation split.  Video corpora: the
                                 # first split% of each video's frames train,
                                 # the tail is held out (index.VideoCorpus).
                                 # Logo pairs: held-out tail of the sorted
                                 # pair list (index.PairedIndex — an upgrade:
                                 # dataset_logo.lua ignores its split lists)
    cacheDir: str = ""           # dataset-index cache dir; "" = co-located
                                 # with the data (<DATA_ROOT>/.index_cache/;
                                 # donkey_folder.lua:29-32 used CWD-relative
                                 # cache/, which littered the working dir)

    # --- extra options (train.lua:29-33) ---
    conditionAdv: bool = False
    noiseGen: bool = False
    noisetype: str = "normal"    # "uniform" | "normal"
    nz: int = 100

    # --- video regime (train_vid_weighted.lua:23-49) ---
    predLen: int = 1             # frames per clip, channel-folded
    inputLen: int = 0            # tiled-eval group size; 0 = predLen
                                 # (test_vid_wholeim.lua:41-43)
    weight_nomask: float = 1.0   # λ: non-mask L2 weight; 0 = hard composite
    wtgdl: float = 0.0           # gradient-difference-loss weight
    maskName: str = ""           # logo mask PNG
    maskValue: float = 110.0 / 255.0
    loadName: str = ""           # finetune checkpoint name
    loadIter: int = 0
    withInit: bool = False       # initializer-network cascade
    initName: str = ""
    compositeLtOne: bool = False # train_mycrit.lua:431 composites the fake
                                 # with gt outside the mask whenever
                                 # weight_nomask < 1 (vid_weighted only at 0)
    donkey_file: str = ""        # video-donkey variant selector
                                 # (datavid/data.lua:26): a value containing
                                 # "norandblk" picks the
                                 # donkey_folder_norandblk.lua behavior —
                                 # no random-block fallback, and the mask is
                                 # applied AFTER flipping the gt only (mask
                                 # stays frame-fixed, norandblk:141-158)

    @property
    def noRandBlk(self) -> bool:
        return "norandblk" in self.donkey_file

    # --- whole-image patch-array regime (train_wholeim_input.lua:42-43,76-77) ---
    array_h: int = 3
    array_w: int = 3
    out_h: int = 2               # hardcoded 2x2 output patches in reference
    out_w: int = 2
    frameH: int = 0              # serve.py wholeim full-frame wire geometry
    frameW: int = 0              # (e.g. 360x480, the reference corpus,
                                 # datavid/dataset.lua:360-378); 0 = serve
                                 # raw patch arrays

    # --- data locations ---
    DATA_ROOT: str = ""
    DATA_ROOT_GT: str = ""       # second folder for the logo-pair regime
    imDir: str = ""              # demo.lua image dir
    net: str = ""                # demo.lua checkpoint path

    # --- video corpus (configurable; hardcoded in datavid/dataset.lua:344-378) ---
    vidExts: str = ""            # comma-separated per-video filename suffixes
    vidCounts: str = ""          # comma-separated per-video frame counts
    gt1Prob: float = 0.4         # probability of sampling the gt1/ variant dir

    # --- TPU-native extensions (no reference equivalent) ---
    computeDtype: str = "bfloat16"   # conv/matmul compute dtype; params stay f32
    dataParallel: int = 0            # 0 = all local devices on the data axis
    modelParallel: int = 1           # TP axis size (shards bottleneck matmul)
    seqParallel: int = 1             # SP axis size (video3d only): clips
                                     # T-sharded over a ('data','seq') mesh,
                                     # halo-exchange temporal convs
                                     # (parallel/temporal.py); predLen must
                                     # divide by it
    gradAccum: int = 1               # microbatch count: the step splits the
                                     # batch, lax.scans the forward+backward
                                     # over the chunks (BN state chained,
                                     # batch stats per chunk) and applies the
                                     # two Adam updates once on the averaged
                                     # gradients — a batch-512-effective run
                                     # on small-HBM devices
    remat: int = 0                   # 1 = jax.checkpoint each network apply
                                     # (replay forwards during backward).
                                     # Numerics identical; MEASURED to give
                                     # NO temp-memory win for this convnet
                                     # family at ~15% extra FLOPs (scripts/
                                     # measure_remat.py + BASELINE.md) — the
                                     # memory levers that do work are
                                     # gradAccum and batch size.  Kept
                                     # opt-in for other widths/backends
    serveMaxDelayMs: float = 5.0     # serve.py dynamic batching: max wait to
                                     # fill a batch before running a partial
                                     # one (latency bound under low load)
    serveHost: str = "localhost"     # serve.py bind address; 0.0.0.0 puts
                                     # the pod behind a load balancer
                                     # (/healthz rotation) — the default
                                     # stays loopback-only
    evalSplit: str = "train"         # eval/metrics data split: "test" gives
                                     # honest held-out metrics (needs
                                     # split<100) on the center folder
                                     # dataset and the video/video3d/wholeim
                                     # corpora (held-out tail frames per
                                     # video); default "train" matches the
                                     # reference's test scripts, which sample
                                     # the training pump
    evalEvery: int = 0               # >0: every N epochs, score the LIVE
                                     # generator on evalSplit mid-training
                                     # (device-resident, no checkpoint
                                     # fetch) and log an eval record to the
                                     # JSONL/stdout/dashboard.  The
                                     # reference has no in-train eval (its
                                     # QC is display grids); this
                                     # productizes the ledger protocol.
                                     # Single-process only (fail-loud).
    evalBatches: int = 4             # batches per in-train eval event
    keepBest: bool = False           # with evalEvery: whenever the in-train
                                     # eval improves bestMetric, save a
                                     # G+BN-only {name}_best_state.npz
                                     # (loadable by every eval/serve path;
                                     # exempt from keepCheckpoints pruning).
                                     # Every regime's soak shows a measured
                                     # early-stop point (BASELINE.md) —
                                     # this banks the peak automatically.
    bestMetric: str = "hole_l2"      # metric keepBest monitors on evalSplit:
                                     # l2|hole_l2 (lower wins) or
                                     # psnr_db|ssim (higher wins)
    checkpointEvery: int = 20        # epochs (train.lua:460; wholeim uses 2)
    checkpointDir: str = "checkpoints"
    keepCheckpoints: int = 0         # >0: after each save, delete this run's
                                     # older checkpoints beyond the newest N
                                     # (full-width states are ~800 MB each);
                                     # 0 = keep all (reference behavior)
    autoResume: bool = False         # resume from the latest checkpoint of
                                     # `name` if one exists (crash recovery;
                                     # supersedes loadName/loadIter when set)
    haltOnNonFinite: bool = True     # stop with a clear error when a logged
                                     # loss goes NaN/inf (the reference's
                                     # runtrainvid.sh ledger records
                                     # "!!Diverges:" by hand after the fact)
    logEvery: int = 1
    gdlTorchQuirk: bool = False      # reproduce reference GDL-backward-is-MSE bug
    usePallasLoss: bool = False      # Pallas fused weighted-MSE (see
                                     # ops/pallas/fused_loss.py for why off)
    adamMomentsBf16: bool = False    # bf16 Adam moment storage: +8-14%
                                     # step throughput (HBM-bound state),
                                     # slightly perturbed trajectories —
                                     # opt-in (see step._adam_lowmem)
    video3dLevels: int = 5           # 3D family spatial halvings;
                                     # input size = 4*2**levels (128 at 5)
    useBias: bool = False            # reference zeroes conv biases every step
    prefetchDepth: int = 2
    dataDevice: bool = False         # device-resident corpus: decode the
                                     # train split once, synthesize batches
                                     # on the device from the step seed
                                     # (data/device_data.py) — per-step
                                     # host→device traffic becomes a seed;
                                     # batch stream = f(seed, step), so
                                     # resume replays the exact stream
    profileSteps: int = 0            # >0: capture a torch.profiler trace
                                     # over steps [5, 5+profileSteps)
    profileDir: str = "logs/profile"
    device: str = "cuda"             # torch device the step runs on
                                     # ("cuda", "cpu")

    def __post_init__(self) -> None:
        if self.fineSize % 4 != 0:
            raise ValueError("fineSize must be divisible by 4")

    @property
    def nc_total(self) -> int:
        """Channel-folded input width (train_vid_weighted.lua:96)."""
        return self.nc * self.predLen

    @property
    def nc_wholeim_in(self) -> int:
        """Patch-array input channels (train_wholeim_input.lua:118)."""
        return self.nc * self.array_h * self.array_w * self.predLen

    @property
    def nc_wholeim_out(self) -> int:
        """Patch-array output channels (train_wholeim_input.lua:119)."""
        return self.nc * self.out_h * self.out_w

    def replace(self, **kw: Any) -> "Opt":
        return dataclasses.replace(self, **kw)


def from_env(base: Opt | None = None, environ: dict[str, str] | None = None) -> Opt:
    """Env-var override shim matching train.lua:35 semantics."""
    env = os.environ if environ is None else environ
    opt = base or Opt()
    updates = {}
    for f in dataclasses.fields(opt):
        raw = env.get(f.name)
        if raw is not None:
            try:
                updates[f.name] = _coerce(raw, getattr(opt, f.name))
            except ValueError as e:
                raise SystemExit(f"bad value for env var {f.name}: {e}")
    return opt.replace(**updates) if updates else opt


def resolve_device(opt: Opt) -> torch.device:
    """``opt.device`` as a torch.device; raises if it names CUDA and CUDA is
    not available (no silent fallback to the CPU)."""
    dev = torch.device(opt.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={opt.device!r} but CUDA is not available "
                           "on this machine (pass device=cpu to run on the "
                           "CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {opt.device!r}")
    return dev


def from_args(argv: list[str], base: Opt | None = None) -> Opt:
    """CLI override: ``key=value`` pairs over the env-var shim, with the
    reference's names and coercion."""
    opt = from_env(base or Opt())
    names = {f.name for f in dataclasses.fields(opt)}
    updates = {}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"expected key=value, got {arg!r}")
        k, v = arg.split("=", 1)
        if k not in names:
            raise SystemExit(f"unknown option {k!r}")
        try:
            updates[k] = _coerce(v, getattr(opt, k))
        except ValueError as e:
            raise SystemExit(f"bad value for {k}: {e}")
    return opt.replace(**updates) if updates else opt


REGIMES = ("center", "video", "logo", "wholeim", "video3d")


def split_regime(argv: list[str], default: str = "center"
                 ) -> tuple[str, list[str]]:
    """Extract ``regime=<name>`` from key=value argv, validated against
    REGIMES — shared by the train and serve CLIs so both reject typos with
    the same clean error instead of a deep traceback."""
    regime, rest = default, []
    for a in argv:
        if "=" not in a:
            # Silently dropping a positional token (e.g. a mistyped regime)
            # would train/serve the wrong model for hours.
            raise SystemExit(f"expected key=value, got {a!r} "
                             "(regime=<name> selects the model family)")
        k, v = a.split("=", 1)
        if k == "regime":
            regime = v
        else:
            rest.append(a)
    if regime not in REGIMES:
        raise SystemExit(f"unknown regime {regime!r}; expected one of "
                         f"{', '.join(REGIMES)}")
    return regime, rest
