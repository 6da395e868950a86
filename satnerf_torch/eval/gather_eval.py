"""Aggregate per-run eval results into comparison tables (port of
``satnerf_tpu/eval/gather_eval.py``; the same text and LaTeX tables).

Walk an eval output folder, collect each run's eval/eval_semantic
results.json, and emit a text table plus a LaTeX table, with the
SatNeRF-paper altitude-MAE column for DFC2019 scenes.

CLI: python -m satnerf_torch.eval.gather_eval <eval_output_dp> [table_out_fp]
"""

from __future__ import annotations

import json
import os
import sys

from satnerf_torch.logger import logger

# SatNeRF-paper altitude MAE (test) per scene (ref: gather_eval.py:196)
SATNERF_PAPER_MAE = {
    "JAX_004": 1.366,
    "JAX_068": 1.277,
    "JAX_214": 1.676,
    "JAX_260": 1.638,
}

_COLUMNS = [
    ("PSNR (Mean)", "PSNR"),
    ("SSIM (Mean)", "SSIM"),
    ("MAE (Mean)", "MAE"),
    ("MAE (Median)", "MAE med"),
    ("Semantic Accuracy (Mean)", "Acc"),
    ("Semantic Accuracy with no cars (Mean)", "Acc w/o cars"),
    ("mIoU (Mean)", "mIoU"),
    ("Uncertainty at transient (Mean)", "beta@cars"),
]


def _load_results(run_dp: str, split: str) -> dict:
    merged = {}
    for sub in ("eval", "eval_semantic"):
        fp = os.path.join(run_dp, sub, split, "results.json")
        if os.path.isfile(fp):
            with open(fp) as f:
                merged.update(json.load(f))
    return merged


def gather_exp(eval_dp: str, split: str = "test") -> list[dict]:
    """Collect one row per evaluated run found under ``eval_dp``."""
    rows = []
    for name in sorted(os.listdir(eval_dp)):
        run_dp = os.path.join(eval_dp, name)
        if not os.path.isdir(run_dp):
            continue
        res = _load_results(run_dp, split)
        if not res:
            continue
        row = {"run": name}
        for key, short in _COLUMNS:
            if key in res:
                row[short] = res[key]
        # paper-MAE comparison for DFC2019 scenes (by aoi prefix in run name)
        for aoi, mae in SATNERF_PAPER_MAE.items():
            if aoi in name:
                row["SatNeRF paper MAE"] = f"{mae:.3f}"
        rows.append(row)
    return rows


def format_text_table(rows: list[dict]) -> str:
    if not rows:
        return "(no results found)"
    cols = ["run"] + [c for _, c in _COLUMNS if any(c in r for r in rows)]
    if any("SatNeRF paper MAE" in r for r in rows):
        cols.append("SatNeRF paper MAE")
    widths = {
        c: max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in cols
    }
    sep = "+" + "+".join("-" * (widths[c] + 2) for c in cols) + "+"
    out = [sep, "|" + "|".join(f" {c:<{widths[c]}} " for c in cols) + "|", sep]
    for r in rows:
        out.append(
            "|" + "|".join(f" {str(r.get(c, '')):<{widths[c]}} " for c in cols) + "|"
        )
    out.append(sep)
    return "\n".join(out)


def format_latex_table(rows: list[dict]) -> str:
    if not rows:
        return "% no results"
    cols = ["run"] + [c for _, c in _COLUMNS if any(c in r for r in rows)]
    lines = [
        "\\begin{tabular}{" + "l" * len(cols) + "}",
        " & ".join(c.replace("_", "\\_") for c in cols) + " \\\\ \\hline",
    ]
    for r in rows:
        lines.append(
            " & ".join(str(r.get(c, "-")).replace("_", "\\_") for c in cols)
            + " \\\\"
        )
    lines.append("\\end{tabular}")
    return "\n".join(lines)


def gather(eval_dp: str, out_fp: str | None = None, split: str = "test") -> str:
    rows = gather_exp(eval_dp, split)
    text = format_text_table(rows)
    latex = format_latex_table(rows)
    report = text + "\n\n" + latex + "\n"
    if out_fp:
        with open(out_fp, "w") as f:
            f.write(report)
        logger.info("Gather", f"tables written to {out_fp}")
    print(text)
    return report


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    gather(*argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
