"""CLI: python -m satnerf_torch.serve <run_dp> [--host H] [--port P]
[--chunk N] [--epoch E] [--device cuda|cpu] [--fast-sine [1]]

--device defaults to cuda and raises without a GPU; --device cpu runs the
kernels' plain PyTorch versions. --fast-sine renders with the degree-5 sine
(the kernels cover it); the JAX package's sine-swap study
(docs/performance.md "quality gate") measured the eval-time swap as
metric-free on trained checkpoints, RGB and depth both; the altitude bias
of poly5 arises only from training with it."""

from __future__ import annotations

import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    run_dp, kwargs = argv[0], {}
    rest = argv[1:]
    i = 0
    while i < len(rest):
        flag = rest[i]
        if not flag.startswith("-"):
            print(f"unexpected argument {flag!r}\n\n{__doc__}")
            return 1
        key = flag.lstrip("-").replace("-", "_")
        has_val = i + 1 < len(rest) and not rest[i + 1].startswith("-")
        if key == "fast_sine":
            # value optional: a bare --fast-sine means on
            val = rest[i + 1] if has_val else "1"
            kwargs[key] = val.lower() not in ("0", "false", "no", "off")
            i += 2 if has_val else 1
            continue
        if not has_val:
            print(f"missing value for --{key}\n\n{__doc__}")
            return 1
        val = rest[i + 1]
        kwargs[key] = val if key in ("host", "device") else int(val)
        i += 2
    from satnerf_torch.serve import http_server

    http_server.serve(run_dp, **kwargs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
