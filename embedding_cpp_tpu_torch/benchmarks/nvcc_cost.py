"""What a kernel source costs to build: nvcc seconds of one `csrc/*.cu`
with the package's flags, and of the same source with more instances in a
switch (a copy in a temporary directory; the source is only read).

Every call on the card builds the kernels anew, so an instance added to a
source costs its nvcc time in every run of chip_smoke.py.  This script
times a source as it is (`--csrc` another tree's csrc/ to time a parent
commit's), and with `--extra-dims` the projection-layout body
(attention_bse.cu) with `case D:` lines added to its head-dim switch for
each D given, `--repeat` times each, in turns.

    python -m embedding_cpp_tpu_torch.benchmarks.nvcc_cost [--source attention_bse.cu]
        [--csrc DIR] [--extra-dims 48 80 112] [--repeat 2]

The last line of standard output is one JSON object: {variant: [seconds,
...]}, and the `device` entry (nvcc runs on the host; the card's name and
power limit say which machine it was).
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from ..ops._build import CSRC, NVCC_FLAGS, _nvcc

# the head-dim switch of attention_bse.cu's `dispatch_d`
_CASE = re.compile(r"^(\s*)case (\d+): return run\(tc::launch<\d+, SEG>, "
                   r"simt::launch<\d+, SEG>\);$", re.M)


def with_dims(text: str, dims) -> str:
    """attention_bse.cu's source with a `case D:` line for each D of `dims`
    that its head-dim switch lacks, after the switch's last case."""
    cases = list(_CASE.finditer(text))
    if not cases:
        raise ValueError("no head-dim switch in the source")
    have = {int(m[2]) for m in cases}
    indent, end = cases[-1][1], cases[-1].end()
    added = "".join(f"\n{indent}case {d}: return run(tc::launch<{d}, SEG>, "
                    f"simt::launch<{d}, SEG>);" for d in dims if d not in have)
    return text[:end] + added + text[end:]


def nvcc_seconds(source: Path, headers_dir: Path, text: str | None = None) -> float:
    """Seconds of one nvcc build of `source` (or of `text` in its place)
    with the package's flags, its headers from `headers_dir`."""
    with tempfile.TemporaryDirectory(prefix="nvcc_cost_") as tmp:
        for h in headers_dir.glob("*.cuh"):
            shutil.copy(h, tmp)
        src = Path(tmp) / source.name
        src.write_text(source.read_text() if text is None else text)
        t0 = time.perf_counter()
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(Path(tmp) / "out.so"), str(src)],
                           capture_output=True, text=True, timeout=1800)
        seconds = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"nvcc {source.name} failed:\n{r.stdout}\n{r.stderr}")
        return seconds


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", default="attention_bse.cu")
    p.add_argument("--csrc", default=str(CSRC), help="the csrc/ directory to build from")
    p.add_argument("--extra-dims", type=int, nargs="*", default=[],
                   help="head dims to add to the switch in a second variant")
    p.add_argument("--repeat", type=int, default=2)
    args = p.parse_args(argv)

    from ..utils.profiling import device_block

    csrc = Path(args.csrc)
    source = csrc / args.source
    variants = {"as_is": None}
    if args.extra_dims:
        variants["with_" + "_".join(map(str, args.extra_dims))] = with_dims(
            source.read_text(), args.extra_dims)
    times = {name: [] for name in variants}
    for _ in range(args.repeat):
        for name, text in variants.items():
            times[name].append(nvcc_seconds(source, csrc, text))
            print(f"nvcc {args.source} {name}: {times[name][-1]:.1f} s", file=sys.stderr,
                  flush=True)
    result = {"source": str(source), "seconds": times, "device": device_block()}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
