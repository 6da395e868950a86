"""Training loop (port of ``satnerf_tpu/train/loop.py``).

Structure per run:
* the combined ray store moves to the device once; each step gathers its
  batch by permutation indices (``train/data.py``);
* each step's stratified jitter comes from one device ``torch.Generator``
  reseeded from (seed, step) (``step_seed``), so resume and step callbacks
  give one stream;
* metrics are fetched every ``log_every`` steps;
* validation per epoch renders the full test images in fixed-shape chunks
  with solar correction off, computes PSNR/SSIM, builds DSMs for the first
  two images and logs the NCC-registered altitude MAE; the best train/mae
  drives checkpointing;
* at the depth-supervision drop the loop switches to a step without the
  depth render.

Left out of the port: multi-process runs and data parallelism
(``data_parallel > 1`` raises), the visualizers (``viz/`` is not ported;
``Pipeline.visualizers()`` returns none), and blocks of
``steps_per_dispatch`` steps: the reference compiles a block into one
device program, while here each step is its own Python call either way, so
the key is read and has no effect.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time

import numpy as np
import torch

from satnerf_torch.device import resolve_device
from satnerf_torch.eval import metrics as image_metrics
from satnerf_torch.eval.dsm import compute_dsm_and_mae
from satnerf_torch.logger import logger
from satnerf_torch.render.renderer import render_image_chunked
from satnerf_torch.train.checkpoint import CheckpointManager, load_warm_start_params
from satnerf_torch.train.data import (
    DEPTH_KEYS,
    TRAIN_KEYS,
    EpochSampler,
    device_store,
    gather_batch,
)
from satnerf_torch.train.profiling import PhaseProfiler, TraceCapture
from satnerf_torch.train.state import create_train_state, init_params
from satnerf_torch.train.step import build_train_step


def val_chunk_rays(pipeline_cfg) -> int:
    """Validation render chunk in rays.

    ``render_chunk_size`` is the reference's points-per-chunk memory knob;
    it is divided by the points a ray evaluates: ``n_samples``, or
    ``n_samples * 2 + n_importance`` with a fine network. The auto value is
    held between 8,192 and 16,384 rays at ``n_samples`` points per ray, and
    scaled down by the same ratio with a fine network, so a hierarchical
    validation has the footprint the floor was sized for. An explicit
    ``val_chunk_rays`` wins outright.
    """
    explicit = int(getattr(pipeline_cfg, "val_chunk_rays", 0) or 0)
    if explicit > 0:
        return explicit
    n = int(pipeline_cfg.n_samples)
    pts = n
    if getattr(pipeline_cfg, "use_fine_network", False):
        pts = 2 * n + int(getattr(pipeline_cfg, "n_importance", 0))
    floor, cap = max(8192 * n // pts, 1), max(16384 * n // pts, 1)
    return max(floor, min(int(pipeline_cfg.render_chunk_size) // pts, cap))


def step_seed(seed: int, step: int) -> int:
    """The per-step generator seed: a fixed mix of (seed, step)."""
    s = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(step)])
    hi, lo = s.generate_state(2, np.uint32)
    return (int(hi) & 0x7FFFFFFF) << 32 | int(lo)


class Trainer:
    def __init__(self, pipeline, writer=None, log_every: int = 100, device=None) -> None:
        self.pipeline = pipeline
        self.cfg = pipeline.cfg
        self.device = resolve_device(device)
        self.log_every = log_every
        self.writer = writer
        self.history: list[dict] = []
        self.profiler = PhaseProfiler()
        self.trace = TraceCapture()
        self.ckpt: CheckpointManager | None = None
        # host-clock training time and steps, validation and checkpoints excluded
        self.train_seconds = 0.0
        self.steps_timed = 0
        self.val_history: list[dict] = []  # the metrics of every validation
        # rgb and depth of each image of the last validation, and of the
        # validation that saved the best checkpoint
        self.last_val_renders: dict = {}
        self.best_val_renders: dict = {}
        self._stop_requested = False

    def request_stop(self) -> None:
        """Ask the fit loop to checkpoint and exit after the current step."""
        self._stop_requested = True

    def _install_signal_handlers(self):
        """SIGTERM/SIGINT finish the in-flight step, write ckpoints/last and
        return."""
        previous = {}

        def handler(signum, frame):
            self._stop_requested = True  # async-signal-safe: only the flag

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:  # not in the main thread
                pass
        return previous

    def _restore_signal_handlers(self, previous):
        for sig, old in previous.items():
            signal.signal(sig, old)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def fit(self, max_steps: int | None = None, validate_every_epoch: bool = True,
            step_callbacks: dict | None = None):
        """Run the training loop.

        ``step_callbacks`` maps global step numbers to ``fn(state, step)``
        hooks, called exactly when the step counter reaches that step.
        Callback wall time is excluded from the reported training rate.
        """
        cfg = self.cfg
        pipeline = self.pipeline
        dev = self.device
        if cfg.run.data_parallel > 1:
            raise NotImplementedError(
                "data_parallel > 1: data parallelism is not ported yet "
                "(ROADMAP Queue 1 item 13)")
        if not pipeline.loaded:
            pipeline.load_datasets()
        run_dp = cfg.run.run_dp or pipeline.prepare_run()
        if self.writer is None:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(os.path.join(run_dp, "tb"))
            except ImportError:
                self.writer = None

        max_steps = max_steps or cfg.run.max_train_steps
        rgb = pipeline.datasets["rgb"]
        batch_size = cfg.pipeline.batch_size
        subsample = (cfg.pipeline.epoch_subsampling
                     if cfg.pipeline.epoch_subsampling_activated else None)
        sampler = EpochSampler(len(rgb), batch_size, shuffle=cfg.run.shuffle_dataset,
                               seed=cfg.run.seed, subsample=subsample)
        steps_per_epoch = sampler.steps_per_epoch
        num_epochs = max(max_steps // steps_per_epoch, 1)

        # step configs with and without depth (switch at the drop boundary)
        has_depth = "depth" in pipeline.datasets
        scfg_nd = pipeline.step_config(steps_per_epoch, with_depth=False, device=dev)
        scfg_d = (pipeline.step_config(steps_per_epoch, with_depth=True, device=dev)
                  if has_depth else None)
        ds_drop = pipeline.ds_drop_step if has_depth else 0
        if has_depth:
            logger.info("Depth", f"depth supervision active until step {ds_drop}")

        params = init_params(torch.Generator().manual_seed(cfg.run.seed),
                             scfg_nd.render.field, pipeline.t_vocab, device=dev,
                             use_fine_network=scfg_nd.render.use_fine_network)
        state = create_train_state(params, cfg.pipeline.learnrate,
                                   cfg.pipeline.lr_scheduler, steps_per_epoch, num_epochs)

        ckpt = self.ckpt = CheckpointManager(run_dp, cfg.run.save_every_n_epochs,
                                             steps_per_epoch)
        if cfg.run.resume_from_ckpoint:
            state = ckpt.restore(state, path=cfg.run.ckpoint_fp or None)
        elif cfg.run.warm_start_fp:
            # params only: the fresh optimizer and step 0 give a full schedule
            load_warm_start_params(state.params, cfg.run.warm_start_fp)

        store = device_store(rgb.combined, TRAIN_KEYS, device=dev)
        depth_store = depth_sampler = None
        if has_depth:
            dcomb = pipeline.datasets["depth"].combined
            depth_store = device_store(dcomb, DEPTH_KEYS, device=dev)
            # the tie-point set can be smaller than a ray batch
            n_depth = int(dcomb["rays"].shape[0])
            depth_sampler = EpochSampler(n_depth, min(batch_size, n_depth),
                                         seed=cfg.run.seed + 1)

        step_d = build_train_step(scfg_d) if has_depth else None
        step_nd = build_train_step(scfg_nd)
        gen = torch.Generator(device=dev)

        # sanity validation (one image)
        if cfg.run.num_sanity_val_steps > 0 and validate_every_epoch:
            self.validate(state, scfg_nd, epoch=0, display_epoch=0, sanity=True)

        start_step = int(state.step)
        if start_step:
            # replay the samplers to where the interrupted run left off
            sampler.fast_forward(start_step)
            if depth_sampler is not None:
                depth_sampler.fast_forward(min(start_step, ds_drop))
        step_i = start_step
        last_log_step = start_step
        last_metrics: dict | None = None
        t_last = time.perf_counter()

        def close_interval() -> float:
            """Charge the steps since the last boundary to the train clock
            (all but the first interval, which holds the first launches and
            any kernel build) and return their rate."""
            nonlocal last_log_step, t_last
            self._sync()
            now = time.perf_counter()
            if self.steps_timed or last_log_step > start_step:
                self.train_seconds += now - t_last
                self.steps_timed += step_i - last_log_step
            rate = (step_i - last_log_step) / max(now - t_last, 1e-9)
            last_log_step, t_last = step_i, now
            return rate

        prev_handlers = self._install_signal_handlers()
        try:
            while step_i < max_steps and not self._stop_requested:
                use_depth = has_depth and step_i < ds_drop
                fn = step_d if use_depth else step_nd
                self.trace.step(step_i)
                with self.profiler.phase("train_step"):
                    idx = torch.from_numpy(sampler.next_batch()).to(dev)
                    batch = gather_batch(store, idx)
                    if use_depth:
                        didx = torch.from_numpy(depth_sampler.next_batch()).to(dev)
                        batch.update(gather_batch(depth_store, didx, prefix="depth_"))
                    gen.manual_seed(step_seed(cfg.run.seed, step_i))
                    state, last_metrics = fn(state, batch, gen)
                step_i += 1

                if step_i % self.log_every == 0 or step_i >= max_steps:
                    names = list(last_metrics)
                    vals = torch.stack([last_metrics[k].detach().float().reshape(())
                                        for k in names]).tolist()  # waits for the step
                    rate = close_interval()
                    self._log_train(step_i, dict(zip(names, vals)), rate, batch_size)

                if step_callbacks and step_i in step_callbacks:
                    if last_log_step != step_i:
                        close_interval()
                    step_callbacks[step_i](state, step_i)
                    t_last = time.perf_counter()

                # epoch boundary (or end of run) -> validation + checkpoints
                new_epoch = step_i // steps_per_epoch
                at_boundary = step_i % steps_per_epoch == 0
                run_done = step_i >= max_steps
                if validate_every_epoch and (
                    (at_boundary and new_epoch % cfg.run.check_val_every_n_epoch == 0)
                    or run_done
                ):
                    if last_log_step != step_i:
                        close_interval()
                    with self.profiler.phase("validate"):
                        val = self.validate(state, scfg_nd, epoch=new_epoch - 1,
                                            display_epoch=new_epoch)
                    mae = val.get("train/mae")
                    if mae is not None and ckpt.maybe_save_best(state, mae):
                        self.best_val_renders = self.last_val_renders
                    ckpt.maybe_save_epoch(state, new_epoch)
                    ckpt.save_last(state)
                    t_last = time.perf_counter()  # don't charge val/ckpt to the rate

            ckpt.save_last(state)
        finally:
            self._restore_signal_handlers(prev_handlers)
        if self.writer is not None:
            self.writer.flush()
        if self._stop_requested:
            logger.warning("Run", "stop requested (signal or API); checkpointed to last")
        self.trace.close()
        self.profiler.dump(os.path.join(run_dp, "profiler"))
        assert state.step == step_i, (state.step, step_i)
        logger.info("Run", f"finished at step {state.step} "
                           f"({state.step - start_step} steps this session)")
        return state

    @property
    def ms_per_step(self) -> float:
        """Host-clock ms per training step, validation and checkpoints
        excluded (batch gather, logging and the program switch included)."""
        return 1e3 * self.train_seconds / max(self.steps_timed, 1)

    # ------------------------------------------------------------------
    def _log_train(self, step: int, metrics: dict, rate: float, batch_size: int):
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(f"train/{k}", v, step)
            self.writer.add_scalar("train/steps_per_sec", rate, step)
            self.writer.add_scalar("train/rays_per_sec", rate * batch_size, step)
        logger.debug_every_n(
            "Train",
            f"step {step}: loss={metrics['loss']:.4f} psnr={metrics['psnr']:.2f} "
            f"{rate:.1f} it/s",
            n=1,
        )
        self.history.append({"step": step, **metrics})

    # ------------------------------------------------------------------
    def validate(self, state, scfg, epoch: int, display_epoch: int, sanity=False):
        """Full-image validation over the rgb_test split: PSNR and SSIM per
        image, the DSM altitude MAE of the first two (not in the sanity
        pass, which renders one image)."""
        pipeline = self.pipeline
        cfg = self.cfg
        # no validation consumer reads solar-correction outputs
        rcfg = dataclasses.replace(scfg.render, solar_correction=False)
        rgb_test = pipeline.datasets["rgb_test"]
        out: dict = {}
        psnrs: dict = {"train": [], "test": []}
        chunk = val_chunk_rays(cfg.pipeline)
        renders = {}
        n_images = 1 if sanity else len(rgb_test.data)
        for i in range(n_images):
            item = rgb_test.image_item(i)
            split = item["split"]
            res = render_image_chunked(state.params, rcfg, item["rays"], item["extras"],
                                       chunk=chunk, device=self.device)
            renders[item["name"]] = {"rgb": res["rgb"], "depth": res["depth"]}
            h, w = item["h"], item["w"]
            gt = item["rgbs"].reshape(h, w, 3)
            pred = res["rgb"].reshape(h, w, 3)
            psnr = float(image_metrics.psnr(pred, gt))
            ssim = float(image_metrics.ssim(pred, gt))
            psnrs[split].append(psnr)
            sample_idx = i - 1 if split == "test" else i
            if self.writer is not None:
                self.writer.add_scalar(f"{split}/ssim_{sample_idx}", ssim, display_epoch)
                img_stack = np.concatenate([gt, pred], axis=1)
                self.writer.add_image(f"val/{split}_{sample_idx}",
                                      np.moveaxis(img_stack, -1, 0), display_epoch)

            if i <= 1 and not sanity:
                output_dp = os.path.join(cfg.run.run_dp, "visualization", split, "dsm")
                try:
                    with self.profiler.phase("dsm_mae"):
                        mae = compute_dsm_and_mae(rgb_test, item["rays"], res["depth"],
                                                  output_dp, item["name"], epoch)
                    out[f"{split}/mae"] = float(mae["mean"])
                    if self.writer is not None:
                        self.writer.add_scalar(f"{split}/mae", float(mae["mean"]),
                                               display_epoch)
                except Exception as exc:  # DSM failures must not kill training
                    logger.warning("Validate", f"DSM/MAE failed: {exc}")

            out[f"{split}/psnr_{sample_idx}"] = psnr
            out[f"{split}/ssim_{sample_idx}"] = ssim
        for split, vals in psnrs.items():
            if vals:
                out[f"{split}/psnr"] = float(np.mean(vals))
        if psnrs["test"] and self.writer is not None:
            self.writer.add_scalar("test/psnr", out["test/psnr"], display_epoch)
        self.val_history.append({"epoch": display_epoch, "sanity": sanity, **out})
        self.last_val_renders = renders
        logger.info("Validate", f"epoch {display_epoch}: "
                    + " ".join(f"{k}={v:.3f}" for k, v in out.items()))
        return out
