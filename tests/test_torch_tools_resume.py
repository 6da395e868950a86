"""The port's production launcher over a stop and a ``--resume`` on the CPU,
at smoke size: a session ended by a stop request (what SIGTERM does between
two card calls) and resumed ends where one uninterrupted run ends.
"""

from __future__ import annotations

import os

import pytest
import torch

from satnerf_torch.tools.syn_long_run import main as launcher_main

SMOKE = [
    "--steps", "16", "--batch", "256", "--units", "16",
    "--img-size", "24", "--n-train", "2", "--n-test", "1",
    "--tie-points", "50", "--val-every", "2", "--device", "cpu",
]


def _run_dirs(out_root):
    ws = os.path.join(out_root, "training")
    return sorted(os.listdir(ws)) if os.path.isdir(ws) else []


def _ckpt(out_root, name="last") -> dict:
    (run,) = _run_dirs(out_root)
    return torch.load(os.path.join(out_root, "training", run, "ckpoints", f"{name}.ckpt"),
                      weights_only=True)


def _stop_after(monkeypatch, stop_step, sessions):
    """Wrap ``Trainer.fit`` to record each Trainer with the state it ends at
    and, where ``stop_step`` is given, call ``request_stop`` from a step
    callback at that step (what SIGTERM does between two card calls)."""
    from satnerf_torch.train.loop import Trainer

    fit = Trainer.fit

    def wrapped(self, *args, step_callbacks=None, **kwargs):
        callbacks = dict(step_callbacks or {})
        if stop_step is not None:
            prior = callbacks.get(stop_step)

            def stop(state, step):
                if prior is not None:
                    prior(state, step)
                self.request_stop()

            callbacks[stop_step] = stop
        state = fit(self, *args, step_callbacks=callbacks or None, **kwargs)
        sessions.append((self, state))
        return state

    monkeypatch.setattr(Trainer, "fit", wrapped)


@pytest.fixture
def one_thread():
    """One intra-op thread: two identical CPU runs on several threads were
    seen to end a few ulps apart, which a bitwise comparison of two runs
    cannot tell from a resume fault."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stopped_session_resumes_bitwise_as_the_straight_run(tmp_path, monkeypatch,
                                                              one_thread):
    """A 16-step run stopped at step 8 by a stop request, then ``--resume``
    to its 16 steps, ends where 16 steps straight end: parameters, Adam state
    and step bitwise, the same validations (every second epoch of 4 steps)
    with the same metrics, the same ``best`` checkpoint, and the best MAE so
    far carried over the stop. (An 8-step run extended to 16 could not: the
    depth supervision drop is a quarter of the run's length.)"""
    from satnerf_torch.train.checkpoint import CheckpointManager

    cfg = SMOKE
    eval_at = ["--eval-at", "4,12"]
    split, straight = str(tmp_path / "split"), str(tmp_path / "straight")
    split_sessions, straight_sessions = [], []
    with monkeypatch.context() as m:
        _stop_after(m, 8, split_sessions)
        assert launcher_main([split] + cfg + eval_at) == 0
    first = _ckpt(split)
    assert first["step"] == 8
    assert first["best_mae"] == min(v["train/mae"] for v in split_sessions[0][0].val_history)
    assert sorted(f for f in os.listdir(split) if f.startswith("results")) == [
        "results_step4.json"]
    with monkeypatch.context() as m:
        _stop_after(m, None, split_sessions)
        assert launcher_main([split, "--resume", "--device", "cpu"] + eval_at) == 0
    with monkeypatch.context() as m:
        _stop_after(m, None, straight_sessions)
        assert launcher_main([straight] + cfg) == 0
    a, b = _ckpt(split), _ckpt(straight)
    assert a["step"] == b["step"] == 16
    assert sorted(a["state_dict"]) == sorted(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for sa, sb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        for k in sa:
            assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), k
    history = [v for t, _ in split_sessions for v in t.val_history]
    assert [v["epoch"] for v in history] == [2, 4]
    assert history == straight_sessions[0][0].val_history
    assert a["best_mae"] == b["best_mae"] == min(v["train/mae"] for v in history)
    best_a, best_b = _ckpt(split, "best"), _ckpt(straight, "best")
    assert best_a["step"] == best_b["step"]
    for k, v in best_a["state_dict"].items():
        assert torch.equal(v, best_b["state_dict"][k]), k
    trainer, state = split_sessions[-1]
    restored = CheckpointManager(trainer.cfg.run.run_dp, write=False)
    restored.restore(state)
    assert restored.best_mae == a["best_mae"]
    assert sorted(f for f in os.listdir(split) if f.startswith("results")) == [
        "results_step12.json", "results_step4.json"]
