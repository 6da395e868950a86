"""Point-cloud export: per-view .ply clouds in UTM and normalised frames
(port of ``satnerf_tpu/eval/extract_pointcloud.py``).

xyz + rgb colours + normals (the sun direction, which gives the
lighting-aware clouds the paper shows), full and 30k-point filtered
variants drawn with a fixed seed. PLY is written by an in-house binary
little-endian writer.

CLI: python -m satnerf_torch.eval.extract_pointcloud <run_dp> [output_dp]
     [--split test|train] [--epoch N] [--chunk N] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from satnerf_torch.core.rays import extras_component
from satnerf_torch.device import resolve_device
from satnerf_torch.eval.dsm import create_dsm_cloud_from_nerf
from satnerf_torch.eval.loader import load_run
from satnerf_torch.eval.util import run_eval_script
from satnerf_torch.logger import logger
from satnerf_torch.render.renderer import render_image_chunked

_VERTEX = [("x", "<f8"), ("y", "<f8"), ("z", "<f8"), ("red", "u1"), ("green", "u1"),
           ("blue", "u1"), ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]


def save_ply(points, colors, normals, output_fp: str):
    """Binary little-endian PLY with double x y z, uchar rgb, float normals."""
    points = np.asarray(points, np.float64)
    colors = np.clip(np.asarray(colors, np.float64), 0, 1)
    normals = np.asarray(normals, np.float32)
    n = points.shape[0]
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
         "property double x", "property double y", "property double z",
         "property uchar red", "property uchar green", "property uchar blue",
         "property float nx", "property float ny", "property float nz", "end_header", ""]
    )
    rec = np.zeros(n, dtype=_VERTEX)
    rec["x"], rec["y"], rec["z"] = points.T
    rec["red"], rec["green"], rec["blue"] = (colors * 255).astype(np.uint8).T
    rec["nx"], rec["ny"], rec["nz"] = normals.T
    if not output_fp.endswith(".ply"):
        output_fp += ".ply"
    with open(output_fp, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def read_ply(fp: str):
    """Read back a PLY written by save_ply."""
    with open(fp, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii")
    n = int([ln for ln in header.splitlines() if ln.startswith("element vertex")][0].split()[-1])
    return np.frombuffer(data[head_end:], dtype=_VERTEX, count=n)


def create_dsm_pointcloud(input_dp: str, output_dp: str, split: str = "test", epoch: int = -1,
                          results_dir_name: str = "pointclouds", max_items: int = 1000000,
                          chunk: int = 16384, filter_points: int = 30000, device=None):
    if not os.path.isdir(input_dp):
        raise FileNotFoundError(f"not a run dir: {input_dp}")
    dev = resolve_device(device)
    pipeline, params, rcfg, step = load_run(input_dp, epoch, device=dev)

    run_name = os.path.basename(input_dp.rstrip("/"))
    output_dp = os.path.join(output_dp, run_name, results_dir_name, split)
    os.makedirs(output_dp, exist_ok=True)

    dataset = pipeline.datasets["rgb" if split == "train" else "rgb_test"]
    until = min(max_items, len(dataset.data))
    for img_idx in range(until):
        img = dataset.image_item(img_idx)
        res = render_image_chunked(params, rcfg, img["rays"], img["extras"], chunk=chunk,
                                   device=dev)
        export_image_clouds(dataset, img, res, output_dp, step, filter_points)
    logger.info("Cloud", f"extracted {until} point clouds to {output_dp}")


def export_image_clouds(dataset, img: dict, res: dict, output_dp: str, step: int,
                        filter_points: int = 30000):
    """All cloud variants of one rendered image (shared with eval.eval_all)."""
    depth = res["depth"]
    cloud_n = dataset.get_xyz_from_nerf_prediction(img["rays"], depth)
    cloud = create_dsm_cloud_from_nerf(dataset, img["rays"], depth)
    colors = res["rgb"]
    normals = np.asarray(extras_component(img["extras"], "sun_d"))

    name = f"{img['name']}_epoch_{step}"
    save_ply(cloud, colors, normals, os.path.join(output_dp, name))
    save_ply(cloud_n, colors, normals, os.path.join(output_dp, name + "_normalized"))

    # fixed-seed filtered versions (ref: extract_pointcloud.py:96-112)
    rng = np.random.default_rng(0)
    idx = rng.permutation(cloud_n.shape[0])[:filter_points]
    save_ply(cloud[idx], colors[idx], normals[idx], os.path.join(output_dp, name + "_filtered"))
    save_ply(cloud_n[idx], colors[idx], normals[idx],
             os.path.join(output_dp, name + "_normalized_filtered"))


def main(argv=None):
    from satnerf_torch.eval.eval_nerf import _parse

    argv = argv if argv is not None else sys.argv[1:]
    args, kwargs = _parse(argv)
    run_eval_script(create_dsm_pointcloud, *args, **kwargs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
