"""K6's ping-pong against a lockstep stream, on one card.

K6 (``satnerf_torch/csrc/trunk_ws.cuh``) differs from K3 in two ways: its
loop (a producer warpgroup streaming the weights through full/empty
mbarriers, the f32 weights split into tf32 hi and lo once by the wrapper, no
block-wide barrier per chunk) and its schedule (named barriers hand the
tensor cores from one consumer warpgroup to the other at every pass, so one
warpgroup's epilogue runs under the other's products). This script tells the
two apart. It builds a second copy of K6 from a patched copy of ``csrc/``:
the turn barriers removed and the weight stream alternated between the
warpgroups chunk by chunk, so both consumers issue at once as K3's
warpgroups do (each waits only on chunks inside the producer's window, so
the parity waits stay exact). It checks that copy bitwise against K3, then
times K3, K6 and the lockstep copy in turns (K3, K6, lockstep, lockstep,
K6, K3; CUDA events, 5 calls each) at ``chip_smoke.K6_TIME_SHAPES``.

    python3 k6_ablation.py

It needs one card (it exits with 2 without one), builds into the ignored
``build/``, prints one JSON line per shape, the card's name and power limit,
and ``{"ok": true, ...}`` last. The patch names the exact lines it edits
and fails when the kernel's source no longer holds them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
# (text in csrc/trunk_ws.cuh, its lockstep replacement)
LOCKSTEP = (
    ("  if (g == 1) bar_arrive(kTurn0);  // warpgroup 0 takes the tensor cores first\n", ""),
    ("    if (g == 1 || i == 0) bar_sync(mine);\n", ""),
    ("    bar_arrive(theirs);\n", ""),
    ("    bar_sync(mine);\n", ""),
    ("    if (g == 0 || !last) bar_arrive(theirs);\n", ""),
    ("      if (g == 0) bar_sync(mine);", "      bar_sync(kLayer);"),
    ("for (int pg = 0; pg < 4; ++pg) {", "for (int pg = 0; pg < 2; ++pg) {"),
    ("const size_t base = (pg >> 1) * pr.pass_bytes + (pg & 1) * kStep;",
     "const size_t base0 = pg * pr.pass_bytes;"),
    ("for (int c = 0; kChunk * c < pr.steps; ++c, ++q) {",
     "for (int cg = 0; kChunk * (cg >> 1) < pr.steps; ++cg, ++q) {\n"
     "          const int c = cg >> 1;\n"
     "          const size_t base = base0 + (cg & 1) * kStep;"),
    ("    v.q = q0 + u;\n", "    v.q = q0 + 2 * u;\n"),
    ("v.q = q0 + (v.prod ? ch0 : 0) + t / kChunk;",
     "v.q = q0 + 2 * ((v.prod ? ch0 : 0) + t / kChunk);"),
    ("mma_phase<T>(q + g * nch,", "mma_phase<T>(q + g,"),
    ("mma_phase<T>(q + (2 + g) * nch,", "mma_phase<T>(q + 2 * nch + g,"),
)


def lockstep_source(csrc: str) -> str:
    """csrc/trunk_ws.cuh with LOCKSTEP applied (each edit exactly once)."""
    with open(os.path.join(csrc, "trunk_ws.cuh")) as f:
        src = f.read()
    for old, new in LOCKSTEP:
        if src.count(old) != 1:
            raise RuntimeError(f"k6_ablation: csrc/trunk_ws.cuh no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build_lockstep() -> tuple:
    """(ctypes handle, ptxas log) of trunk_fwd.cu built with the lockstep loop,
    under build/satnerf_torch/k6_lockstep-<hash>/."""
    from satnerf_torch.ops import _build

    src = lockstep_source(_build.CSRC)
    out = os.path.join(REPO, "build", "satnerf_torch",
                       "k6_lockstep-" + hashlib.sha256(src.encode()).hexdigest()[:12])
    shutil.copytree(_build.CSRC, os.path.join(out, "csrc"), dirs_exist_ok=True)
    with open(os.path.join(out, "csrc", "trunk_ws.cuh"), "w") as f:
        f.write(src)
    so = os.path.join(out, "libtrunk_fwd.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                          os.path.join(out, "csrc", "trunk_fwd.cu")],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"k6_ablation: nvcc failed:\n{res.stdout[-4000:]}{res.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build._SIGNATURES["trunk_fwd"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.satnerf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.satnerf_cuda_error_string.restype = ctypes.c_char_p
    return lib, res.stdout + res.stderr


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k6_ablation: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from satnerf_torch.configs import load_render_config
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.device import disable_tf32
    from satnerf_torch.models.field import Field, fused_field_spec
    from satnerf_torch.ops import _build
    from satnerf_torch.ops import field_fused as ff
    from satnerf_torch.ops import trunk

    disable_tf32()
    dev = torch.device("cuda")
    _build.build_all(("trunk_fwd",))
    lib, log = build_lockstep()
    spills = [line.strip() for line in log.splitlines() if "spill stores" in line]
    cs.emit({"phase": "k6_ablation_build", "lockstep_spills": spills})

    def lockstep(sp, x, packed):
        with mock.patch.object(trunk, "load_library", lambda name: lib):
            return trunk.fused_trunk_interleaved(sp, x, packed)

    rcfg = load_render_config(cs.PIPELINE_TOML, device=dev, trunk_impl="pallas", **cs.BETA_S)
    field = Field(rcfg.field, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    spec = fused_field_spec(rcfg.field)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for dname, n, case in cs.K6_TIME_SHAPES:
            dt = torch.float32 if dname == "float32" else torch.bfloat16
            if case == "proto":
                sp, x, packed = cs.k6_proto_case(dev, spec, dt)
            else:
                sp, packed = spec, field.packed(dt)
                enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1,
                                          rcfg.field.mapping_pos_n_freq).to(dev)
                x = ff.pack_x(spec, enc, dt)
            k3 = trunk.fused_trunk(sp, x, packed)
            bitwise = (torch.equal(lockstep(sp, x, packed), k3)
                       and torch.equal(trunk.fused_trunk_interleaved(sp, x, packed), k3))
            cs.check(bitwise, f"k6_ablation: K6 or its lockstep copy not bitwise K3 at {n}")
            ms = {"k3": [], "k6": [], "lockstep": []}
            for name in ("k3", "k6", "lockstep", "lockstep", "k6", "k3"):
                fn = {"k3": trunk.fused_trunk, "k6": trunk.fused_trunk_interleaved,
                      "lockstep": lockstep}[name]
                ms[name].append(cs.cuda_ms(lambda: fn(sp, x, packed), reps=5))
            mean = {k: sum(v) / len(v) for k, v in ms.items()}
            cs.emit({"phase": "k6_ablation", "dtype": dname, "points": n, "c_in": sp.c_in,
                     "bitwise_k3": bitwise, "turns_ms": ms,
                     "k6_over_k3": mean["k6"] / mean["k3"],
                     "lockstep_over_k3": mean["lockstep"] / mean["k3"],
                     "k6_over_lockstep": mean["k6"] / mean["lockstep"]})
            del x, k3
    print(cs.smi_line(), flush=True)
    cs.emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
