"""videotgb_torch's config composition and run utilities against
videotgb_tpu's, on the CPU.

The port reads ``configs/`` with its own YAML reader (it does not depend on
PyYAML): every file must load to what ``yaml.safe_load`` gives, and
``compose`` must give the JAX package's config for the train and eval roots
with every experiment and the override sets of ``tests/test_entries.py``.
The run snapshot written by the port's dumper must read back through
``yaml.safe_load``. Only this test imports ``yaml``. All comparisons are
exact.
"""

import ast
import datetime
import glob
import logging
import math
import os

import numpy as np
import pytest
import yaml

from videotgb_torch.config import core as TC
from videotgb_torch.config import yaml_lite
from videotgb_torch.train import CONFIG_DIR
from videotgb_torch.utils import logging as TL
from videotgb_torch.utils import task as TT
from videotgb_torch.utils import writers as TW
from videotgb_tpu.config import core as JC
from videotgb_tpu.utils import logging as JL
from videotgb_tpu.utils import task as JT
from videotgb_tpu.utils import writers as JW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_FILES = sorted(os.path.relpath(p, CONFIG_DIR) for p in glob.glob(
    os.path.join(CONFIG_DIR, "**", "*.yaml"), recursive=True))
EXPERIMENTS = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(CONFIG_DIR, "experiment", "*.yaml")))


def same(a, b):
    """Equality that treats two NaNs as equal."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


# ------------------------------------------------------------- YAML reader
@pytest.mark.parametrize("rel", YAML_FILES)
def test_yaml_reader_equals_safe_load_on_every_config(rel):
    with open(os.path.join(CONFIG_DIR, rel)) as f:
        text = f.read()
    assert same(yaml_lite.load(text), yaml.safe_load(text))


SCALARS = ["5.0e-5", "1e-4", "1.0e+3", "6.0e-5", "1e5", "1.", ".5", "+.inf",
           "-.inf", ".nan", "-1", "+7", "0", "017", "0o17", "0x1F", "0b101",
           "1_000", "1:30", "-1:30", "1:30.5", "yes", "No", "ON", "off",
           "true", "False", "TRUE", "tRue", "~", "null", "Null", "NULL",
           "nUll", "2024-01-02", "???", "${paths.root_dir}/data",
           "val/score", "loguniform(1e-6,1e-3)", "a b c", "'quoted # not'",
           '"esc\\t\\"q\\u00e9"', "'it''s'", "x # comment", "[1, 2.0, a]",
           "[[1, 2], [], {}]", "{a: 1, b: [x, 'y']}", "{}", "[]"]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_reader_resolves_scalars_as_safe_load(text):
    doc = f"k: {text}\n"
    assert same(yaml_lite.load(doc), yaml.safe_load(doc))


BLOCKS = [
    "a:\n  - 1\n  - b: 2\n    c: [3]\n  -\n    - x\n    - y\n",
    "- a: 1\n  b: 2\n- c\n- - d\n  - e\n",
    "defaults:\n- data: synthetic\n- _self_\nx: 1\n",
    "a:\n  b:\n    c: null\n  d:\ne: 'q: r'\n",
    "# only a comment\n",
    "",
]


@pytest.mark.parametrize("doc", BLOCKS)
def test_yaml_reader_block_structures(doc):
    assert same(yaml_lite.load(doc), yaml.safe_load(doc))


DUMPED = [
    {"a": 1e-5, "b": 1e20, "c": -0.0, "d": float("inf"), "e": float("nan")},
    {"s": ["1e-4", "yes", "", "x y", "-x", "a: b", "#c", "${now:%H}", "???",
           "null", "017", "2024-01-02", "é\n\t\"q\""]},
    {"n": None, "t": True, "f": False, "i": -3, "l": [], "m": {},
     "nested": [[1, [2]], {"k": [{"v": 1}]}]},
    [1, "two", {"three": 3}],
]


@pytest.mark.parametrize("obj", DUMPED)
def test_snapshot_dumper_round_trips_through_safe_load(obj):
    text = yaml_lite.dump(obj)
    assert same(yaml.safe_load(text), obj)
    assert same(yaml_lite.load(text), obj)


# ------------------------------------------------------------------ compose
class _Frozen(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


@pytest.fixture
def frozen_now(monkeypatch):
    """One instant for both packages' ``${now:...}``."""
    monkeypatch.setattr(datetime, "datetime", _Frozen)


def both(name, overrides):
    port = TC.to_dict(TC.compose(CONFIG_DIR, name, overrides))
    ref = JC.to_dict(JC.compose(os.path.join(REPO, "configs"), name,
                                overrides))
    return port, ref


@pytest.mark.parametrize("name", ["train", "eval"])
@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_compose_equals_jax_for_every_experiment(frozen_now, name,
                                                 experiment):
    port, ref = both(name, [f"experiment={experiment}"])
    assert same(port, ref)
    assert port["hydra"]["run"]["dir"].endswith("2026-01-02_03-04-05")


OVERRIDES = {
    "none": [],
    "cpu": ["experiment=smoke_tg_synthetic", "trainer=cpu"],
    "fdr": ["experiment=smoke_e2e_synthetic", "debug=fdr"],
    "profiler": ["experiment=smoke_tg_synthetic", "debug=profiler"],
    "debug_default": ["debug=default"],
    "callbacks_none": ["callbacks=none"],
    "callbacks_es": ["callbacks=early_stopping"],
    "progress": ["callbacks=rich_progress_bar"],
    "many_loggers": ["logger=many_loggers"],
    "ddp_sim": ["trainer=ddp_sim"],
    "optuna": ["hparams_search=videoinstruct_optuna"],
    "dotted": ["experiment=smoke_e2e_synthetic", "model.optimizer.lr=1e-4",
               "+new.key=3", "data.flow_len_range=[8,64]", "seed=7",
               "paths.root_dir=/x/y", "model.selection=tgb",
               "callbacks.model_checkpoint.save_last=false", "tags=null"],
}


@pytest.mark.parametrize("name", ["train", "eval"])
@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_compose_equals_jax_with_overrides(frozen_now, name, case):
    port, ref = both(name, OVERRIDES[case])
    assert same(port, ref)


@pytest.mark.parametrize("text", ["null", "None", "~", "true", "False", "3",
                                  "-2.5", "1e-4", "[8, 64]", "{'a': 1}",
                                  "'q'", "word", "a=b", "(1, 2)"])
def test_override_values_parse_as_jax(text):
    assert same(TC._parse_value(text), JC._parse_value(text))


def test_instantiate_merge_and_resolve_match_jax():
    node = {"_target_": "collections.OrderedDict", "days": 2,
            "inner": {"_target_": "datetime.timedelta", "hours": 1}}
    assert TC.instantiate(node) == JC.instantiate(node) == {
        "days": 2, "inner": datetime.timedelta(hours=1)}
    part = {"_target_": "datetime.timedelta", "_partial_": True, "days": 1}
    assert TC.instantiate(part)(hours=3) == JC.instantiate(part)(hours=3)
    base = {"a": {"b": 1, "c": [1]}, "d": "${a.b}/x", "e": "${a.c}"}
    over = {"a": {"c": [2]}, "f": "${d}"}
    assert same(TC.to_dict(TC.resolve(TC.merge(base, over))),
                JC.to_dict(JC.resolve(JC.merge(base, over))))


# ------------------------------------------------------------ run utilities
def test_setup_run_dir_writes_the_snapshot_and_job_log(frozen_now, tmp_path):
    argv = ["experiment=smoke_tg_synthetic", f"paths.root_dir={tmp_path}",
            "model.optimizer.lr=1e-4"]
    cfg = TC.compose(CONFIG_DIR, "train", argv)
    run_dir = TT.setup_run_dir(cfg, job_name="train", overrides=argv)
    try:
        TL.get_logger("videotgb_torch.test").info("hello from the run")
        assert run_dir == cfg.paths.output_dir
        assert run_dir.endswith("train/runs/2026-01-02_03-04-05")
        # every path derived from the output dir follows the run dir
        assert cfg.paths.ckpt_dir == os.path.join(run_dir, "checkpoints")
        assert cfg.callbacks.model_checkpoint.dirpath == cfg.paths.ckpt_dir
        with open(os.path.join(run_dir, ".hydra", "config.yaml")) as f:
            assert same(yaml.safe_load(f), TC.to_dict(cfg))
        with open(os.path.join(run_dir, ".hydra", "overrides.yaml")) as f:
            assert yaml.safe_load(f) == argv
        with open(os.path.join(run_dir, "train.log")) as f:
            assert "hello from the run" in f.read()
        # a second run in the same second gets its own directory
        cfg2 = TC.compose(CONFIG_DIR, "train", argv)
        assert TT.setup_run_dir(cfg2, overrides=argv) == run_dir + "_1"
    finally:
        TL.remove_file_handler(TT.setup_run_dir._handler)
    # an explicit output dir opts out of the run dir
    argv = [f"paths.output_dir={tmp_path}/pinned"]
    cfg = TC.compose(CONFIG_DIR, "train", argv)
    assert TT.setup_run_dir(cfg, overrides=argv) == f"{tmp_path}/pinned"


def test_extras_and_metric_value_match_jax():
    import warnings

    cfg = TC.Config({"extras": {"enforce_tags": True, "print_config": False},
                     "tags": []})
    for mod in (TT, JT):
        with pytest.raises(ValueError, match="tags"):
            mod.apply_extras(cfg)
    with warnings.catch_warnings():
        TT.apply_extras(TC.Config({"extras": {"ignore_warnings": True,
                                              "print_config": False}}))
        assert warnings.filters[0][0] == "ignore"
    metrics = {"val/score": 0.5}
    for mod in (TT, JT):
        assert mod.get_metric_value(metrics, "val/score") == 0.5
        assert mod.get_metric_value(metrics, None) is None
        with pytest.raises(KeyError):
            mod.get_metric_value(metrics, "val/other")


def test_print_config_tree_matches_jax(frozen_now):
    cfg = TC.compose(CONFIG_DIR, "train", ["experiment=smoke_e2e_synthetic"])
    quiet = logging.getLogger("quiet-config-tree")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    assert TL.print_config_tree(cfg, quiet) == JL.print_config_tree(cfg, quiet)


def test_csv_writer_layout_matches_jax(tmp_path, monkeypatch):
    rows = [({"loss": 1.5, "lr": 0.0}, 1), ({"loss": 1.25, "lr": 1e-5}, 2),
            ({"val/loss": 1.0, "val/score": 0.5}, 2), ({"loss": 1.0}, 3)]
    monkeypatch.setattr("time.time", lambda: 1234.5)
    for mod, sub in ((TW, "port"), (JW, "jax")):
        w = mod.build_writers(["csv"], str(tmp_path / sub))
        w.log_hyperparams({"config": {"a": 1}})
        for metrics, step in rows:
            w.log_metrics(metrics, step)
        w.finish()
    for name in ("metrics.csv", "hparams.json"):
        got = (tmp_path / "port" / "csv" / name).read_text()
        assert got == (tmp_path / "jax" / "csv" / name).read_text()
    # a resumed run adopts the existing header and appends
    w = TW.CSVWriter(str(tmp_path / "port" / "csv"))
    w.log_metrics({"loss": 0.5}, 4)
    lines = (tmp_path / "port" / "csv" / "metrics.csv").read_text().split()
    assert lines[0].startswith("step,time,loss,lr,val/loss,val/score")
    assert lines[-1].startswith("4,1234.5,0.5")


def test_writers_for_missing_packages_are_skipped_as_in_jax(tmp_path):
    names = ["csv", "wandb", "aim", "comet", "mlflow", "neptune"]
    port = TW.build_writers(names, str(tmp_path / "p"))
    ref = JW.build_writers(names, str(tmp_path / "j"))
    assert ([type(w).__name__ for w in port.writers]
            == [type(w).__name__ for w in ref.writers])
    for cls in (TW.WandbWriter, TW.AimWriter, TW.CometWriter,
                TW.MLFlowWriter, TW.NeptuneWriter):
        try:
            cls()
        except ImportError:
            pass  # the package is absent: the writer refuses in __init__


# ------------------------------------------------------------------ imports
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "videotgb_tpu")
PORT_SOURCES = sorted(glob.glob(os.path.join(REPO, "videotgb_torch", "**",
                                             "*.py"), recursive=True))


def test_no_port_module_imports_jax_yaml_or_the_jax_package():
    found = []
    for path in PORT_SOURCES + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                if mod.split(".")[0] in FORBIDDEN:
                    found.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert len(PORT_SOURCES) > 50
    assert not found, found


def test_the_config_reader_is_the_port_s_own():
    """``load_yaml`` reads through ``yaml_lite``, never PyYAML."""
    path = os.path.join(CONFIG_DIR, "model", "LSTP_TG_blip2.yaml")
    cfg = TC.load_yaml(path)
    assert cfg.optimizer.lr == 5e-5 and isinstance(cfg.optimizer.lr, float)
    assert np.isclose(cfg.scheduler.warmup, 0.05)
