"""The nvcc wall time of two layouts of the instances of kernel 1, of the
attention backward, of the sequence-parallel kernel, of the split-tensor
kernel and of the block kernel's streamed design at head widths 16, 32 and
40.

    python3 -m vision_transformer_cam_tpu_torch.scripts.width_units

"One unit a width" is the sources as they are: ``csrc/masked_attention_w16.cu``,
``_w32.cu``, ``_w40.cu``, and the three of each other kernel.  "One unit a
kernel" merges each kernel's three into one translation unit.  Each layout
is a copy of ``kernels/csrc`` in a temporary directory whose every ``.cu``
is compiled to an object by its own nvcc process, all started together, as
``kernels/_build.py`` builds the library; the two layouts one after the
other.  Prints each layout's wall time and each unit's, and returns them.
Needs nvcc (no GPU).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from vision_transformer_cam_tpu_torch.kernels import _build
from vision_transformer_cam_tpu_torch.utils import check_cli_flags

WIDTHS = (16, 32, 40)
# each kernel's width units (stem_w16.cu, ...) and the header they include
HEADERS = {"masked_attention": "masked_attention.cuh",
           "masked_attention_bwd": "masked_attention_bwd.cuh",
           "masked_attention_seq": "masked_attention_seq.cuh",
           "masked_attention_v1": "masked_attention_v1.cuh",
           "attention_block_streamed": "attention_block_streamed.cuh"}
LAYOUTS = {"one unit a width": False, "one unit a kernel": True}


def merged_unit(csrc: Path, stem: str) -> str:
    """One translation unit holding what ``stem``'s width units hold: their
    header included once, then each unit's entry points."""
    include = f'#include "{HEADERS[stem]}"\n'
    bodies = []
    for w in WIDTHS:
        text = (csrc / f"{stem}_w{w}.cu").read_text()
        if text.count(include) != 1:
            raise ValueError(f"width_units: {stem}_w{w}.cu does not include "
                             f"{HEADERS[stem]} once")
        bodies.append(text.split(include, 1)[1])
    return include + "".join(bodies)


def layout(csrc: Path, dst: Path, merged: bool) -> Path:
    """A copy of ``csrc`` at ``dst``, its width units merged a kernel when
    ``merged``."""
    shutil.copytree(csrc, dst)
    if merged:
        for stem in HEADERS:
            (dst / f"{stem}_w16_32_40.cu").write_text(merged_unit(csrc, stem))
            for w in WIDTHS:
                (dst / f"{stem}_w{w}.cu").unlink()
    return dst


def compile_all(src: Path):
    """(wall s, {unit: its nvcc wall s}) of compiling every ``.cu`` of
    ``src`` to an object, one nvcc process each, all started together."""
    nvcc, t0 = _build._nvcc(), time.perf_counter()
    procs = {s.name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(s.with_suffix(".o")),
         str(s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s in sorted(src.glob("*.cu"))}

    def finish(item):
        name, p = item
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"width_units: nvcc failed for {name}:\n{out}")
        return name, time.perf_counter() - t0
    with ThreadPoolExecutor(len(procs)) as pool:
        units = dict(pool.map(finish, procs.items()))
    return time.perf_counter() - t0, units


def main(argv=None):
    """{layout: (wall s, {unit: s})}, each layout printed as it ends."""
    argv = list(sys.argv[1:] if argv is None else argv)
    check_cli_flags(["width_units"] + argv, bool_flags=(), value_flags=(),
                    prog="width_units")
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, merged) in enumerate(LAYOUTS.items()):
            wall, units = compile_all(
                layout(_build.CSRC, Path(tmp) / f"layout{i}", merged))
            got[name] = (wall, units)
            print(f"width_units {name}: {len(units)} sources in {wall:.1f} "
                  "s; " + ", ".join(f"{k} {v:.1f} s"
                                    for k, v in sorted(units.items())),
                  flush=True)
    return got


if __name__ == "__main__":
    main()
