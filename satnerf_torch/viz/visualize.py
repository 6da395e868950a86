"""Visualization harness: render per-image panels to TensorBoard and GeoTIFF
(port of ``satnerf_tpu/viz/visualize.py``).

ref: framework/visualize.py:24-313 — ``ImageVisualization`` subclasses
produce either a (H, W) scalar map (colormapped for TB), a (3, H, W) image,
or a stack (N, 3, H, W); outputs go to TensorBoard (through tensorboardX,
when it imports) and/or to GeoTIFFs with the RPC tags of the source image.
``run_visualizer`` re-runs the whole suite over a trained run's split,
rendering each image through the kernels (K1 + K5) on the card.
"""

from __future__ import annotations

import os
import time

import numpy as np

from satnerf_torch.io.image import save_output_image
from satnerf_torch.logger import logger
from satnerf_torch.viz.colormaps import apply_colormap, scale_for_tensorboard

SCALE_LARGE = 600
SCALE_SMALL = 400


class ImageVisualization:
    """Base visualizer (ref: framework/visualize.py:47-160)."""

    def __init__(self, cfg, send_to_tensorboard: bool = True,
                 save_as_tif: bool = False) -> None:
        self.cfg = cfg
        self.send_to_tensorboard = send_to_tensorboard
        self.save_as_tif = save_as_tif

    # subclass API ---------------------------------------------------------
    def _name(self) -> str:
        raise NotImplementedError

    def _colormap(self) -> str:
        return "bone"

    def _visualize(self, dataset, sample, results, w, h):
        """Return (H, W) | (3, H, W) | (N, 3, H, W) | None."""
        raise NotImplementedError

    def _for_tensorboard(self, out: np.ndarray) -> np.ndarray:
        """Default: colormap scalar maps, pass images through, downscale."""
        if out.ndim == 2:
            out = np.moveaxis(apply_colormap(out, self._colormap()), -1, 0)
        if out.ndim == 3:
            return scale_for_tensorboard(out, SCALE_LARGE)
        return out  # stacks are already prepared by the subclass

    def tif_path(self, run_dp: str, split: str, name: str, epoch: int) -> str:
        return os.path.join(run_dp, "visualization", split, self._name(),
                            f"{name}_epoch_{epoch}.tif")

    # running ---------------------------------------------------------------
    def run(self, dataset, sample: dict, results: dict, writer=None,
            sample_idx: int = 0, split: str = "test", epoch: int = 0,
            source_fp: str | None = None, run_dp: str | None = None) -> None:
        w, h = sample["w"], sample["h"]
        out = self._visualize(dataset, sample, results, w, h)
        if out is None:
            return
        out = np.asarray(out)

        if self.send_to_tensorboard and writer is not None:
            img = self._for_tensorboard(out)
            if img.ndim == 3:
                img = img[None]
            writer.add_images(
                f"{split}_{sample_idx}/{self._name()}",
                img.astype(np.float32) if img.dtype != np.uint8 else img,
                epoch,
            )

        if self.save_as_tif and run_dp is not None:
            tif = out[None] if out.ndim == 2 else out
            if tif.ndim == 4:  # stacks are TB-only
                return
            save_output_image(np.ascontiguousarray(tif, dtype=np.float32),
                              self.tif_path(run_dp, split, sample["name"], epoch),
                              source_fp=source_fp)


def run_all(visualizers, dataset, sample, results, writer=None, sample_idx=0,
            split="test", epoch=0, run_dp=None):
    """Every visualizer on one image; a failing one is logged and skipped,
    so a panel never stops training."""
    source_fp = sample.get("img_fp")
    for viz in visualizers:
        try:
            viz.run(dataset, sample, results, writer=writer, sample_idx=sample_idx,
                    split=split, epoch=epoch, source_fp=source_fp, run_dp=run_dp)
        except Exception as exc:  # visualization must never kill training
            logger.warning("Viz", f"{viz._name()} failed: {exc}")


def default_visualizers(cfg, semantic: bool = False, has_sun: bool = True,
                        has_beta: bool = True):
    """The per-pipeline visualizer sets
    (ref: baseline/pipelines/satnerf.py:74-112,
    semantic/pipelines/rs_semantic.py:87-118)."""
    from satnerf_torch.viz import baseline_viz as b

    viz = [
        b.TensorboardSummaryVisualization(cfg, True, False),
        b.FactorVisualization(cfg, True, True, "rgb"),
        b.FactorVisualization(cfg, True, True, "depth"),
        b.RGBDiffDistanceVisualization(cfg, True, False),
        b.AltsVisualization(cfg, True, True),
    ]
    if has_sun:
        viz += [
            b.FactorVisualization(cfg, True, True, "albedo"),
            b.FactorVisualization(cfg, True, True, "sun", cmap="bone"),
            b.FactorVisualization(cfg, True, True, "irradiance"),
            b.FactorVisualization(cfg, True, True, "sky"),
        ]
    if has_beta:
        viz += [b.FactorVisualization(cfg, True, True, "beta", cmap="bone")]
    if semantic:
        from satnerf_torch.viz import semantic_viz as s

        viz += [
            s.SemanticColorVisualization(cfg, False, True),
            s.SemanticErrorVisualization(cfg, False, True),
            s.TensorboardSemanticSummaryVisualization(cfg, True, False),
            s.SemanticColorShadingVisualization(cfg, True, True),
            s.ConfusionMatrixVisualization(cfg, True, False),
            s.TensorboardSemanticClassVisualization(cfg, True, False),
        ]
        if "corrupted" in getattr(cfg.pipeline, "semantic_dataset_type", ""):
            viz += [s.TensorboardSemanticSummaryVisualization(
                cfg, True, False, compare_non_corrupted=True)]
    return viz


def run_visualizer(input_dp: str, output_dp: str | None = None, split: str = "test",
                   epoch: int = -1, chunk: int = 16384, device=None) -> list:
    """Re-run the visualizer suite over a trained run's split
    (ref: framework/visualize.py:198-313 + semantic/run_visualizer.py).

    ``split`` "test" renders the test dataset (its first image is the
    prepended train view), "train" the train dataset. Returns one record per
    image: its name, split, and the seconds of the render and of the
    visualizers (numpy, TIF writes, TensorBoard).
    """
    from satnerf_torch.eval.loader import load_run
    from satnerf_torch.render.renderer import render_image_chunked

    pipeline, params, rcfg, step = load_run(input_dp, epoch, device=device)
    run_dp = output_dp or input_dp
    dataset = pipeline.datasets["rgb" if split == "train" else "rgb_test"]
    fcfg = rcfg.field
    visualizers = default_visualizers(pipeline.cfg, semantic=fcfg.has_semantic,
                                      has_sun=fcfg.has_sun, has_beta=fcfg.has_beta)

    writer = None
    try:
        from tensorboardX import SummaryWriter

        writer = SummaryWriter(os.path.join(run_dp, "tb_visualizer"))
    except ImportError:
        pass

    records = []
    try:
        for i in range(len(dataset.data)):
            sample = dataset.image_item(i)
            t0 = time.perf_counter()
            results = render_image_chunked(params, rcfg, sample["rays"], sample["extras"],
                                           chunk=chunk, device=device)
            t1 = time.perf_counter()
            sample_idx = i - 1 if sample["split"] == "test" else i
            run_all(visualizers, dataset, sample, results, writer=writer,
                    sample_idx=sample_idx, split=sample["split"], epoch=step,
                    run_dp=run_dp)
            records.append({"name": sample["name"], "split": sample["split"],
                            "render_s": t1 - t0, "viz_s": time.perf_counter() - t1})
    finally:
        if writer is not None:
            writer.close()
    logger.info("Viz", f"visualizations written under {run_dp}/visualization")
    return records
