"""Build a CUDA source of the port for the CPU emulation in this folder.

The source is rewritten in three places, then compiled by ``g++`` as
C++20 against ``cuda_runtime.h`` / ``cuda_bf16.h`` here:

- ``extern __shared__ T name[];`` -> a pointer to the block's emulated
  dynamic shared memory;
- ``__shared__`` -> ``static`` (blocks run one at a time, so a static
  array is the block's own);
- ``kernel<<<grid, block, smem, stream>>>(args);`` -> ``emu_launch(&kernel,
  grid, block, smem, [&] { kernel(args); });`` (the launch is held to the
  shared-memory limit that ``cudaFuncSetAttribute`` set for that kernel).

The library keeps the source's ``extern "C"`` entry points, so the
port's ctypes wrappers can drive it with CPU pointers.
``atomicAdd(float*, float)`` is a ``std::atomic_ref`` add (a block's
threads run at once; blocks run in turn, so the order across blocks is
fixed here, unlike on the card).  Inline PTX and tensor-core
instructions are not emulated; the mbarrier and 1-D bulk-copy helpers
of ``csrc/sm90.cuh`` have plain twins in ``sm90.cuh`` here, which the
build finds first.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
_LAUNCH = re.compile(r"([\w:]+(?:<[^;{}]*?>)?)<<<(.*?)>>>\((.*?)\);", re.S)


def compiler():
    return shutil.which("g++")


def translate(source: str) -> str:
    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_dyn_smem);", source)
    text = text.replace("__shared__ ", "static ")

    def launch(m):
        cfg = [c.strip() for c in m.group(2).split(",")] + ["0", "0"]
        return (f"emu_launch(reinterpret_cast<const void*>(&{m.group(1)}), "
                f"{cfg[0]}, {cfg[1]}, {cfg[2]}, [&] "
                f"{{ {m.group(1)}({m.group(3)}); }});")

    return _LAUNCH.sub(launch, text)


def build(cu_path, out_dir) -> Path:
    """Compile ``cu_path`` for the emulation into ``out_dir``; returns
    the shared library's path.  Raises ``RuntimeError`` with g++'s
    output if it refuses the source."""
    cu_path, out_dir = Path(cu_path), Path(out_dir)
    cpp = out_dir / (cu_path.stem + "_emu.cpp")
    lib = out_dir / ("lib" + cu_path.stem + "_emu.so")
    cpp.write_text(translate(cu_path.read_text()))
    cmd = [compiler(), "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
           f"-I{HERE}", "-w", "-o", str(lib), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ refused {cu_path.name}:\n{proc.stderr}")
    return lib
