"""The port's ``tools.syn_long_run`` and the JAX package's
``tools/syn_long_run.py`` launch the same run, for the two runs that
``rung_audit.py`` resolves: the quality gate (``--gate``) and the
hierarchical production run (``--hier``).

At the gate's flags (``--steps 8000 --seed 0 --sc-stride 1``,
``docs/performance.md`` "Strided solar-correction quadrature") and at the
hierarchical run's (``--n-importance 128 --use-fine-network --steps 30000
--seed 7``, ``docs/validation_run.md`` "Hierarchical (coarse-to-fine)
production run") each launcher runs up to its ``Trainer``, which is stubbed
here, as is the loading of the datasets (about 20 s a package for the RPC
rays): nothing trains. ``rung_audit.py`` must resolve those flags, and
``--hier`` its stop at step 12,900. Both launchers must resolve equal run
and pipeline settings, call ``generate_scene`` with equal arguments and
write the same scene, byte for byte (the full 8 + 3 views of 256², 16,000
tie points), and give for its training rays (the train views' pixels) the
same steps per epoch from their own samplers, the same depth drop step,
beta and car-reg epochs from their own step configs, and the same learning
rate at the case's steps from their own schedules.
"""

from __future__ import annotations

import filecmp
import importlib
import importlib.util
import json
import os
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per run: rung_audit.py's flags, the launchers' flags it must resolve, the
# steps whose learning rate is compared, and (rays, steps per epoch, depth drop
# step, first beta epoch, car-reg), the pipeline's (batch, remat_chunks,
# n_importance, use_fine_network) and rung_audit's stop step
RUNS = {
    "gate": (["--gate", "--seed", "0"], ["--steps", "8000", "--seed", "0", "--sc-stride", "1"],
             (0, 2000, 8000), (8 * 256**2, 64, 2000, 2, (True, 3)), (8192, 0, 0, False), 0),
    "hier": (["--hier"], ["--n-importance", "128", "--use-fine-network", "--steps", "30000",
                          "--seed", "7"],
             (0, 7500, 12900), (8 * 256**2, 128, 7500, 2, (True, 3)), (4096, 2, 128, True),
             12900),
}


def _launch(monkeypatch, pkg: str, root: str, main) -> dict:
    """Run one package's launcher with its Trainer stubbed -> what it resolved."""
    synthetic = importlib.import_module(f"{pkg}.datasets.synthetic")
    pipelines = importlib.import_module(f"{pkg}.pipelines")
    loop = importlib.import_module(f"{pkg}.train.loop")
    seen: dict = {}
    generate, load = synthetic.generate_scene, pipelines.load_pipeline

    def generate_scene(out_dp, **kw):
        seen["scene"] = (os.path.relpath(out_dp, root), kw)
        return generate(out_dp, **kw)

    def load_pipeline(cfgs):
        seen["pipeline"] = pipeline = load(cfgs)
        pipeline.load_datasets = lambda *a, **kw: None
        return pipeline

    class Trainer:
        def __init__(self, pipeline, **kw):
            self.pipeline, self.cfg = pipeline, pipeline.cfg
            self.steps_timed, self.ms_per_step = 0, 0.0

        def fit(self, step_callbacks=None):
            return types.SimpleNamespace(step=self.cfg.run.max_train_steps)

    monkeypatch.setattr(synthetic, "generate_scene", generate_scene)
    monkeypatch.setattr(pipelines, "load_pipeline", load_pipeline)
    monkeypatch.setattr(loop, "Trainer", Trainer)
    assert main() == 0
    return seen


def _settings(dump: dict, root: str) -> dict:
    """A config dump with the launcher's root and the run's time stamp taken out."""
    out = {}
    for k, v in dump.items():
        if isinstance(v, str):
            v = v.replace(root, "<root>")
            if k in ("run_name", "run_dp") and v:  # past the stamp
                v = os.path.join(os.path.dirname(v), os.path.basename(v)[19:])
        out[k] = v
    return out


def _train_rays(scene_dp: str) -> int:
    root = json.load(open(os.path.join(scene_dp, "root.json")))
    metas = [json.load(open(os.path.join(scene_dp, root["meta_dp"], n)))
             for n in root["train_split"]]
    return sum(m["width"] * m["height"] for m in metas)


def _resolved(pkg: str, pipeline, sampler_cls, schedule, lr_steps) -> dict:
    cfg = pipeline.cfg
    rays = _train_rays(os.path.join(cfg.run.datasets_dp, cfg.run.dataset_name))
    subsample = (cfg.pipeline.epoch_subsampling
                 if cfg.pipeline.epoch_subsampling_activated else None)
    spe = sampler_cls(rays, cfg.pipeline.batch_size, shuffle=cfg.run.shuffle_dataset,
                      seed=cfg.run.seed, subsample=subsample).steps_per_epoch
    num_epochs = max(cfg.run.max_train_steps // spe, 1)
    kw = {"device": "cpu"} if pkg == "satnerf_torch" else {}
    scfg = pipeline.step_config(spe, with_depth=True, **kw)
    lr = schedule(cfg.pipeline.learnrate, cfg.pipeline.lr_scheduler, spe, num_epochs)
    return {"rays": rays, "steps_per_epoch": spe, "num_epochs": num_epochs,
            "depth_drop_step": pipeline.ds_drop_step,
            "first_beta_epoch": scfg.first_beta_epoch,
            "car_reg": (scfg.use_car_reg_loss, scfg.car_reg_loss_start),
            "sc_stride": scfg.render.sc_stride,
            "lr": [float(lr(s)) for s in lr_steps]}


def _flags(argv: list) -> dict:
    """A command line -> {flag: its value, or True for a flag alone}."""
    out, i = {}, 0
    while i < len(argv):
        alone = i + 1 == len(argv) or argv[i + 1].startswith("--")
        out[argv[i]] = True if alone else argv[i + 1]
        i += 1 if alone else 2
    return out


def _rung_audit():
    spec = importlib.util.spec_from_file_location("rung_audit",
                                                  os.path.join(REPO, "rung_audit.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("run", sorted(RUNS))
def test_both_launchers_resolve_the_same_gate_run(run, tmp_path, monkeypatch):
    from satnerf_torch.tools import syn_long_run as tlaunch
    from satnerf_torch.train import data as tdata
    from satnerf_torch.train.schedule import make_lr_schedule as tschedule
    from satnerf_tpu.train import data as jdata
    from satnerf_tpu.train.schedule import make_lr_schedule as jschedule

    audit_flags, flags, lr_steps, want, pipe_want, stop = RUNS[run]
    spec = importlib.util.spec_from_file_location(
        "jax_tools_syn_long_run", os.path.join(REPO, "tools", "syn_long_run.py"))
    jlaunch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jlaunch)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    # rung_audit.py resolves the launcher's flags (and --hier its stop)
    audit = _rung_audit()
    audit_args = audit.parse_args([troot, "--variant", "kernels_bf16", *audit_flags])
    argv = audit.run_argv(audit_args)
    assert argv[0] == troot and audit_args.stop_at == stop
    assert _flags(argv[1:]) == _flags(flags) | {"--eval-at": ""}
    j = _launch(monkeypatch, "satnerf_tpu", jroot, lambda: jlaunch.main([jroot, *flags]))
    t = _launch(monkeypatch, "satnerf_torch", troot,
                lambda: tlaunch.main([*argv, "--device", "cpu"]))

    assert t["scene"] == j["scene"]
    assert j["scene"][1] == dict(n_train=8, n_test=3, img_size=256, n_tie_points=16000,
                                 aoi_name="SYN_LONG", seed=0)
    cmp = filecmp.dircmp(os.path.join(jroot, "scene"), os.path.join(troot, "scene"))
    assert not (cmp.left_only or cmp.right_only or cmp.funny_files)
    for sub in [cmp, *cmp.subdirs.values()]:
        assert not (sub.left_only or sub.right_only)
        _, mismatch, errors = filecmp.cmpfiles(sub.left, sub.right, sub.common_files,
                                               shallow=False)
        assert not mismatch and not errors, (sub.left, mismatch, errors)

    jcfg, tcfg = j["pipeline"].cfg, t["pipeline"].cfg
    assert _settings(tcfg.run.dump_dict(), troot) == _settings(jcfg.run.model_dump(), jroot)
    assert tcfg.pipeline.dump_dict() == jcfg.pipeline.model_dump()
    assert (tcfg.pipeline.compute_dtype, tcfg.pipeline.fc_units, tcfg.pipeline.n_samples,
            tcfg.pipeline.sin_impl) == ("bfloat16", 512, 64, "poly")
    assert (tcfg.pipeline.batch_size, tcfg.pipeline.remat_chunks, tcfg.pipeline.n_importance,
            tcfg.pipeline.use_fine_network) == pipe_want

    tres = _resolved("satnerf_torch", t["pipeline"], tdata.EpochSampler, tschedule, lr_steps)
    jres = _resolved("satnerf_tpu", j["pipeline"], jdata.EpochSampler, jschedule, lr_steps)
    lr_t, lr_j = tres.pop("lr"), jres.pop("lr")
    assert tres == jres
    assert (tres["rays"], tres["steps_per_epoch"], tres["depth_drop_step"],
            tres["first_beta_epoch"], tres["car_reg"]) == want
    # the JAX schedule raises 0.9 to the epoch in f32 (jnp), the port in f64:
    # 3.3e-6 apart at step 8,000 (epoch 125), f32's rounding over 125 factors
    np.testing.assert_allclose(lr_t, lr_j, rtol=1e-5, atol=0)
    assert lr_t == [5e-4 * 0.9 ** (s // want[1]) for s in lr_steps]
