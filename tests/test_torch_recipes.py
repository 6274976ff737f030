"""The port's experiment recipes (video_filler_tpu_torch/scripts/
run_train_video.sh, run_test_video.sh) against the JAX package's
(scripts/run_train_video.sh, run_test_video.sh): the same recipe names,
the same key=value options in each, run by the port's CLI where the JAX
file runs the JAX package's; each recipe's options parse through the
port's ``config.from_args`` to the Opt the JAX package's parser makes;
the default mask exists.  The shell files are read, not run (a recipe
trains at full width)."""

import dataclasses
import os
import re
import shlex

import pytest

from video_filler_tpu import config as jconfig
from video_filler_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "scripts")
PORT_DIR = os.path.join(ROOT, "video_filler_tpu_torch", "scripts")
ARMS = ["canonical", "maskvalue0", "finetune", "l2gdl", "init", "wholeim"]
# what the environment gives the recipes in a run
ENV = {"DATA_ROOT": "corpus", "MASK": "assets/masks/maskppp.png",
       "INIT_NET": "checkpoints/init_5_state.npz",
       "NET": "checkpoints/net_5_state.npz", "seed": "24751"}


def _read(path):
    with open(path) as f:
        return f.read().replace("\\\n", " ")


def _expand(word):
    """A shell word with ``${v:-default}`` and ``$v`` expanded from ENV."""
    word = re.sub(r"\$\{(\w+):-([^}]*)\}",
                  lambda m: ENV.get(m.group(1), m.group(2)), word)
    return re.sub(r"\$(\w+)", lambda m: ENV[m.group(1)], word)


def _commands(text):
    """Each ``python -m MODULE args`` line: (MODULE, [args])."""
    out = []
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words[:2] == ["python", "-m"]:
            args = words[3:]
            if args and args[-1] == ";;":
                args = args[:-1]
            out.append((words[2], [_expand(a) for a in args]))
    return out


def _arms(text):
    """{recipe: (module, args)} of a train recipe file's ``case``."""
    found = re.findall(r"^\s+(\w+)\)(.*?);;", text, re.M | re.S)
    return {name: _commands(body)[0] for name, body in found}


def _default(text, var):
    return re.search(rf'{var}="\$\{{{var}:-([^}}]*)\}}"', text).group(1)


TRAIN = {"jax": _arms(_read(os.path.join(JAX_DIR, "run_train_video.sh"))),
         "port": _arms(_read(os.path.join(PORT_DIR, "run_train_video.sh")))}


def test_the_same_recipes_on_both_sides():
    assert list(TRAIN["jax"]) == ARMS
    assert list(TRAIN["port"]) == ARMS


def _asdict(opt):
    d = dataclasses.asdict(opt)
    d.pop("device", None)
    return d


@pytest.mark.parametrize("arm", ARMS)
def test_recipe_has_the_jax_options_and_parses_in_the_port(arm,
                                                           monkeypatch):
    jmod, jargs = TRAIN["jax"][arm]
    tmod, targs = TRAIN["port"][arm]
    assert (jmod, tmod) == ("video_filler_tpu.train",
                            "video_filler_tpu_torch.train")
    assert targs == jargs
    assert len({a.split("=")[0] for a in targs}) == len(targs)
    for k in [f.name for f in dataclasses.fields(tconfig.Opt)]:
        monkeypatch.delenv(k, raising=False)
    regime, rest = tconfig.split_regime(targs)
    assert (regime, rest) == jconfig.split_regime(jargs)
    opt = tconfig.from_args(rest)
    assert _asdict(opt) == _asdict(jconfig.from_args(rest))
    assert opt.device == "cuda"          # the card, unless the env says
    for a in rest:
        k, v = a.split("=", 1)
        assert str(getattr(opt, k)) == v or float(getattr(opt, k)) == \
            float(v), a


def test_eval_sweep_has_the_jax_options_and_seeds(monkeypatch):
    texts = {side: _read(os.path.join(d, "run_test_video.sh"))
             for side, d in (("jax", JAX_DIR), ("port", PORT_DIR))}
    (jmod, jargs), = _commands(texts["jax"])
    (tmod, targs), = _commands(texts["port"])
    assert (jmod, tmod) == ("video_filler_tpu.eval.wholeim",
                            "video_filler_tpu_torch.eval.wholeim")
    assert targs == jargs
    assert _default(texts["port"], "SEEDS") == \
        _default(texts["jax"], "SEEDS") == "24751 5079 7814 37062 4791"
    for k in [f.name for f in dataclasses.fields(tconfig.Opt)]:
        monkeypatch.delenv(k, raising=False)
    opt = tconfig.from_args(targs)
    assert _asdict(opt) == _asdict(jconfig.from_args(jargs))
    assert (opt.manualSeed, opt.name, opt.predLen) == (24751, "eval_s24751",
                                                       4)


@pytest.mark.parametrize("name", ["run_train_video.sh", "run_test_video.sh"])
def test_default_mask_exists_and_is_the_jax_files(name):
    port = _default(_read(os.path.join(PORT_DIR, name)), "MASK")
    assert port == _default(_read(os.path.join(JAX_DIR, name)), "MASK")
    assert os.path.isfile(os.path.join(ROOT, port))
