"""The ledger and soak configurations of the JAX package's ``scripts/``,
one preset per ``scripts/run_*.py`` (and the keepBest demo's), letter for
letter: the work directory the script uses, the synthetic corpora it
builds there (data/synthetic.py, byte-equal to the JAX package's), the
``Opt`` keyword arguments, the ``run_ledger`` keyword arguments and the
result file.  tests/test_torch_ledger.py reads each script with ``ast``
and holds its preset to it.

The scripts compute the heldout and logo_wholeim tags as
``step{checkpointEvery * spe}`` and ``step{niter * spe}``, spe being the
steps per epoch of the clamped train split; the presets hold the values.
"""

from __future__ import annotations

import dataclasses

__all__ = ["KEEPBEST", "PRESETS", "Preset", "Run"]


@dataclasses.dataclass(frozen=True)
class Run:
    """One ``run_ledger`` call of a script."""
    regime: str
    opt: dict            # the script's Opt(...) keyword arguments
    mid_tag: str
    final_tag: str
    splits: tuple = ("train", "test")
    ledger: dict = dataclasses.field(default_factory=dict)
    # the call's other run_ledger keyword arguments (max_steps, save,
    # score_every), as the script passes them


@dataclasses.dataclass(frozen=True)
class Preset:
    script: str          # the JAX package's script, relative to the repo
    workdir: str         # the script's WORK directory, by its last name
    corpora: tuple       # (data.synthetic function, args, kwargs), in order
    results: str         # the result file, written into the work directory
    runs: dict           # run key -> Run, in the script's order
    default: tuple = ()  # the runs made when none is named (empty: all)
    # logo_wholeim names its file after a run picked alone (its argv[1])
    results_per_run: bool = False

    def default_runs(self) -> tuple:
        return self.default or tuple(self.runs)

    def results_file(self, keys) -> str:
        keys = tuple(keys)
        if self.results_per_run and keys != self.default_runs():
            return f"{self.results[:-len('.json')]}_{'_'.join(keys)}.json"
        return self.results


IMAGES_256 = ("make_image_folder", ("images",),
              dict(n=256, h=160, w=200, seed=0))
IMAGES_512 = ("make_image_folder", ("images",),
              dict(n=512, h=160, w=200, seed=0))
IMAGES_2048 = ("make_image_folder", ("images",),
               dict(n=2048, h=160, w=200, seed=0))
VIDEOS = (("make_video_corpus", ("corpus",),
           dict(n_videos=4, frames=64, h=180, w=240)),
          ("make_mask_png", ("mask.png",), dict(h=180, w=240)))
PAIRS = ("make_paired_folders", ("pairs",), dict(n=1024, h=160, w=200))

# scripts/run_heldout_ledgers.py: split=80 leaves 205 images / 204 frames
# to train on: 3 steps/epoch at batch 64, 6 at batch 32.
_HELDOUT = dict(loadSize=150, fineSize=128, nBottleneck=4000, wtl2=0.999,
                ntrain=256, nThreads=2, manualSeed=222, display=False,
                logEvery=400, split=80)
# the center recipe of the 2048-texture corpus (run_center_bigcorpus.py,
# run_condadv_ledger.py, run_noisegen_ledger.py; the soaks add dataDevice)
_CENTER = dict(DATA_ROOT="images", batchSize=64, overlapPred=4,
               loadSize=150, fineSize=128, nBottleneck=4000, wtl2=0.999,
               nThreads=2, manualSeed=222, display=False, split=80)
_LOGO = dict(DATA_ROOT="pairs/masked", DATA_ROOT_GT="pairs/gt_pairs",
             batchSize=64, loadSize=150, fineSize=128, nBottleneck=4000,
             wtl2=0.999, ntrain=1024, nThreads=2, manualSeed=222,
             display=False)
_WHOLEIM = dict(DATA_ROOT="corpus", maskName="mask.png", loadSize=180,
                batchSize=32, nef=192, ngf=192, ndf=128, nBottleneck=6400,
                wtl2=0.999, weight_nomask=0.05, ntrain=192, nThreads=2,
                manualSeed=222, display=False)
_VIDEO3D = dict(DATA_ROOT="corpus", maskName="mask.png", batchSize=32,
                predLen=4, weight_nomask=0.05, loadSize=150, fineSize=128,
                nBottleneck=4000, wtl2=0.999, ntrain=256, nThreads=2,
                manualSeed=222, display=False, split=80)


def _soak(max_steps: int, score_every: int) -> dict:
    return dict(max_steps=max_steps, save=False, score_every=score_every)


PRESETS: dict[str, Preset] = {
    "heldout": Preset(
        "scripts/run_heldout_ledgers.py", "heldout3", (IMAGES_256, *VIDEOS),
        "heldout_results.json", {
            "center": Run("center", dict(
                DATA_ROOT="images", batchSize=64, overlapPred=4, niter=1000,
                checkpointEvery=267, name="hc", **_HELDOUT),
                "step801", "step3000"),
            "video": Run("video", dict(
                DATA_ROOT="corpus", maskName="mask.png", batchSize=64,
                predLen=2, weight_nomask=0.05, niter=1000,
                checkpointEvery=267, name="hv", **_HELDOUT),
                "step801", "step3000"),
            "video3d": Run("video3d", dict(
                DATA_ROOT="corpus", maskName="mask.png", batchSize=32,
                predLen=4, weight_nomask=0.05, niter=500,
                checkpointEvery=133, name="h3", **_HELDOUT),
                "step798", "step3000"),
        }),
    "bigcorpus": Preset(
        "scripts/run_center_bigcorpus.py", "bigcorpus", (IMAGES_2048,),
        "bigcorpus_results.json", {
            "center": Run("center", dict(
                _CENTER, ntrain=1664, logEvery=400, niter=120,
                checkpointEvery=32, name="bc"), "mid", "final"),
        }),
    "center_soak": Preset(
        "scripts/run_center_soak.py", "bigcorpus", (IMAGES_2048,),
        "center_soak_results.json", {
            "center": Run("center", dict(
                _CENTER, ntrain=1664, logEvery=2600, niter=385,
                checkpointEvery=9999, name="c_soak", dataDevice=True),
                "step3000", "step9625", ledger=_soak(10010, 50)),
        }),
    "center_soak30k": Preset(
        "scripts/run_center_soak30k.py", "bigcorpus", (IMAGES_2048,),
        "center_soak30k_results.json", {
            "center": Run("center", dict(
                _CENTER, ntrain=1664, logEvery=2600, niter=1200,
                checkpointEvery=9999, name="c_soak30k", dataDevice=True),
                "step9625", "step30000", ledger=_soak(30000, 50)),
        }),
    "center_soak512": Preset(
        "scripts/run_center_soak512.py", "midcorpus", (IMAGES_512,),
        "center_soak512_results.json", {
            "center": Run("center", dict(
                _CENTER, ntrain=384, logEvery=1200, niter=1667,
                checkpointEvery=9999, name="c_soak512", dataDevice=True),
                "step3000", "step10002", ledger=_soak(10002, 50)),
        }),
    "center_soak256fine": Preset(
        "scripts/run_center_soak256fine.py", "heldout3", (IMAGES_256,),
        "center_soak256fine_results.json", {
            "center": Run("center", dict(
                _CENTER, ntrain=256, logEvery=300, niter=1000,
                checkpointEvery=9999, name="c_soak256f", dataDevice=True),
                "step1500", "step3000", ledger=_soak(3000, 25)),
        }),
    "logo_soak": Preset(
        "scripts/run_logo_soak.py", "lw_ledgers", (PAIRS,),
        "logo_soak_results.json", {
            "logo": Run("logo", dict(
                _LOGO, logEvery=1000, split=80, niter=625,
                checkpointEvery=9999, name="lg_soak", dataDevice=True),
                "step3024", "step7500", ledger=_soak(10000, 63)),
        }),
    "logo_soak12k": Preset(
        "scripts/run_logo_soak12k.py", "lw_ledgers", (PAIRS,),
        "logo_soak12k_results.json", {
            "logo": Run("logo", dict(
                _LOGO, logEvery=1200, split=80, niter=1042,
                checkpointEvery=9999, name="lg_soak12k", dataDevice=True),
                "step6048", "step12504", ledger=_soak(12504, 42)),
        }),
    "wholeim_soak": Preset(
        "scripts/run_wholeim_soak.py", "lw_ledgers", VIDEOS,
        "wholeim_soak_results.json", {
            "wholeim": Run("wholeim", dict(
                _WHOLEIM, logEvery=1000, split=80, niter=1667,
                checkpointEvery=9999, name="wi_soak", dataDevice=True),
                "step3000", "step10002", ledger=_soak(10002, 250)),
        }),
    "wholeim_soak30k": Preset(
        "scripts/run_wholeim_soak30k.py", "lw_ledgers", VIDEOS,
        "wholeim_soak30k_results.json", {
            "wholeim": Run("wholeim", dict(
                _WHOLEIM, logEvery=3000, split=80, niter=5000,
                checkpointEvery=9999, name="wi_soak30", dataDevice=True),
                "step3000", "step30000", ledger=_soak(30000, 500)),
        }),
    "video3d_soak": Preset(
        "scripts/run_video3d_soak.py", "heldout3", VIDEOS,
        "video3d_soak_results.json", {
            "video3d": Run("video3d", dict(
                _VIDEO3D, logEvery=1000, niter=1667, checkpointEvery=9999,
                name="v3_soak", dataDevice=True),
                "step3000", "step10002", ledger=_soak(10002, 167)),
        }),
    "video3d_soak30k": Preset(
        "scripts/run_video3d_soak30k.py", "heldout3", VIDEOS,
        "video3d_soak30k_results.json", {
            "video3d": Run("video3d", dict(
                _VIDEO3D, logEvery=3000, niter=5000, checkpointEvery=9999,
                name="v3_soak30k", dataDevice=True),
                "step10002", "step30000", ledger=_soak(30000, 500)),
        }),
    "condadv": Preset(
        "scripts/run_condadv_ledger.py", "bigcorpus", (IMAGES_2048,),
        "condadv_results.json", {
            "center": Run("center", dict(
                _CENTER, ntrain=1664, logEvery=400, niter=120,
                checkpointEvery=32, conditionAdv=True, name="ca"),
                "mid", "final"),
        }),
    "noisegen": Preset(
        "scripts/run_noisegen_ledger.py", "bigcorpus", (IMAGES_2048,),
        "noisegen_results.json", {
            "center": Run("center", dict(
                _CENTER, ntrain=1664, logEvery=400, niter=120,
                checkpointEvery=32, noiseGen=True, name="ng"),
                "mid", "final"),
        }),
    # without a run named: wholeim then logo into lw_results.json; a run
    # named alone writes lw_results_<run>.json (the script's argv[1])
    "logo_wholeim": Preset(
        "scripts/run_logo_wholeim_ledgers.py", "lw_ledgers", (*VIDEOS, PAIRS),
        "lw_results.json", {
            "wholeim": Run("wholeim", dict(
                _WHOLEIM, logEvery=400, split=80, niter=500,
                checkpointEvery=133, name="lw_wi"), "step798", "step3000"),
            "logo": Run("logo", dict(
                _LOGO, logEvery=400, niter=188, checkpointEvery=50,
                name="lw_lg"), "step800", "step3008", splits=("train",)),
            "logo_split": Run("logo", dict(
                _LOGO, logEvery=400, split=80, niter=188,
                checkpointEvery=50, name="lw_lg80"), "step600", "step2256"),
        }, default=("wholeim", "logo"), results_per_run=True),
}

# scripts/run_keepbest_demo.py: center on the 512-texture corpus at reduced
# width, in-train eval every 100 epochs on the held-out split, keepBest on
# hole_l2 (ledger/keepbest.py runs it).
KEEPBEST = Preset(
    "scripts/run_keepbest_demo.py", "midcorpus", (IMAGES_512,),
    "keepbest_demo_results.json", {
        "center": Run("center", dict(
            DATA_ROOT="images", batchSize=64, overlapPred=4, loadSize=150,
            fineSize=128, nef=32, ngf=32, ndf=32, nBottleneck=512,
            wtl2=0.999, ntrain=384, nThreads=2, manualSeed=222,
            display=False, logEvery=1200, split=80, niter=1667,
            checkpointEvery=9999, name="kb_demo", dataDevice=True,
            evalEvery=100, evalBatches=16, evalSplit="test", keepBest=True,
            bestMetric="hole_l2"), "", "", splits=("test",)),
    })
