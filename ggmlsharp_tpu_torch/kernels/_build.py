"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

Each source is compiled on its own by nvcc into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<source>-<hash>.so csrc/<source>.cu

The library is named after its source and carries a hash of the source,
the shared headers (``csrc/*.cuh``), the flags and the kernel's ``-D``
macros (``set_defines``: a source's tunables or variants, for a probe that
times the alternatives), so an edited source is rebuilt, an unchanged one
is reused, and several C entries of one source share one library.
``_build/`` is listed in ``.gitignore``. Every C entry returns ``cudaGetLastError()`` after its launch;
``check`` raises if that is not 0. Pointers and the stream go to C as
``c_void_p``.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels carried
it (``reset_launches`` before the run, read after). A kernel with two
entries counts each under its own name (``flash_attn`` for the cached entry,
``flash_attn_uncached`` for the uncached one, one source; ``matmul_q4_0`` and
``matmul_q4_0_mma`` for the b = 1 and the multi-row instance of one source,
likewise ``matmul_q8_0`` and ``matmul_q8_0_mma``, ``matmul_q`` and
``matmul_q_mma``, ``mlp_fused_silu_q4`` and ``mlp_fused_silu_q4_mma``,
``mlp_fused_q8`` and ``mlp_fused_q8_mma``). The
dequant-matmul wrappers also count each launch by shape and launch geometry in
``GEOMETRY_LAUNCHES`` ((kernel, N, K, warps, rows_per_warp, B) -> launches,
the kernel the counter's name; warps and rows_per_warp None for the
multi-row instance, which takes no geometry), so a run can show which
instance and geometry each shape and row count was given.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# kernel name -> (source, C entry, argtypes)
KERNELS = {
    "matmul_q4_0": ("matmul_q4_0.cu", "q4_0_matmul",
                    [_P, _P, _P, _P] + [_I] * 6 + [_P]),
    "flash_attn": ("flash_attn.cu", "flash_attn",
                   [_P, _P, _P, _P, _I, _P] + [_I] * 6 + [_LL, _I, _I, _I, _F,
                                                        _F, _P]),
    "attn_decode": ("attn_decode.cu", "attn_decode",
                    [_P] * 11 + [_I] * 5 + [_LL, _LL, _I, _F, _I, _I, _I, _P]),
    "matmul_q8_0": ("matmul_q8_0.cu", "q8_0_matmul",
                    [_P, _P, _P, _P] + [_I] * 6 + [_P]),
    "mlp_fused_q8": ("mlp_fused_q8.cu", "mlp_fused_q8",
                     [_P] * 9 + [_I] * 6 + [_P, _P, _I, _P]),
    "gpt2_layer": ("gpt2_layer.cu", "gpt2_layer",
                   [_P] * 26 + [_I] * 4 + [_F, _I, _I, _P]),
    "mlp_fused_silu_q4": ("mlp_fused_silu_q4.cu", "mlp_fused_silu_q4",
                          [_P] * 7 + [_I] * 3 + [_P] * 2),
    "llama_layer": ("llama_layer.cu", "llama_layer",
                    [_P] * 24 + [_I] * 5 + [_F, _I, _I, _P]),
    "matmul_q": ("matmul_q.cu", "q_matmul", [_I] + [_P] * 6 + [_I] * 6 + [_P]),
    # the multi-row instances of the sources above (csrc/dq_mma.cuh)
    "matmul_q4_0_mma": ("matmul_q4_0.cu", "q4_0_matmul_mma",
                        [_P] * 3 + [_I] + [_P] * 4 + [_I] * 5 + [_P]),
    "matmul_q8_0_mma": ("matmul_q8_0.cu", "q8_0_matmul_mma",
                        [_P] * 3 + [_I] + [_P] * 4 + [_I] * 6 + [_P]),
    "mlp_fused_silu_q4_mma": ("mlp_fused_silu_q4.cu", "mlp_fused_silu_q4_mma",
                              [_P] * 9 + [_I] * 5 + [_P]),
    "mlp_fused_q8_mma": ("mlp_fused_q8.cu", "mlp_fused_q8_mma",
                         [_P] * 11 + [_I] * 8 + [_P]),
    "matmul_q_mma": ("matmul_q.cu", "q_matmul_mma",
                     [_I] + [_P] * 3 + [_I] + [_P] * 6 + [_I] * 5 + [_P]),
    "matmul_int_dot": ("matmul_int_dot.cu", "int_dot_matmul",
                       [_I] + [_P] * 8 + [_I, _I, _P]),
    # the in-graph length-bucket switch (kernels/graph_switch.py): a
    # parent graph's launch (its selector kernel), its build and teardown,
    # the selector alone (a check), the design the toolkit gave, an error's
    # name
    "graph_switch": ("graph_switch.cu", "graph_switch_launch", [_P, _P]),
    "graph_switch_build": ("graph_switch.cu", "graph_switch_build",
                           [_P, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P, _I,
                            _P]),
    "graph_switch_destroy": ("graph_switch.cu", "graph_switch_destroy", [_P]),
    "graph_switch_select": ("graph_switch.cu", "graph_switch_select",
                            [_P, _I, _I, _P, _I, _P, _I, _I, _P, _I, _P,
                             _P]),
    "graph_switch_design": ("graph_switch.cu", "graph_switch_design", [_P]),
    "graph_switch_error": ("graph_switch.cu", "graph_switch_error",
                           [_I, _P, _I]),
    # the tuning path's probes (ggmlsharp_tpu_torch/probes/)
    "matmul_q4_0_kmajor": ("matmul_q4_0_kmajor.cu", "q4_0_kmajor_matmul",
                           [_P] * 5 + [_I] * 4 + [_P]),
    "probe_copy": ("probes.cu", "probe_copy", [_P, _P, _LL, _P]),
    "probe_byte_order": ("probes.cu", "probe_byte_order",
                         [_P, _I, _P, _P, _P]),
    "probe_f16_decode": ("probes.cu", "probe_f16_decode", [_P, _P, _I, _P]),
    "probe_block_map": ("probes.cu", "probe_block_map",
                        [_I, _P, _P, _I, _P]),
}

# counters beside the kernels' own: flash's uncached entry, and the Q4_0
# dequant-matmul's probe builds (probes/dq_variants.py, -DQ4_UNPACK)
LAUNCHES = {name: 0 for name in (*KERNELS, "flash_attn_uncached",
                                 "matmul_q4_0_i2f", "matmul_q4_0_half2")}
GEOMETRY_LAUNCHES: dict = {}  # (kernel, N, K, warps, rows_per_warp, B) -> n
_DEFINES: dict = {}  # kernel name -> its -D macros, ("NAME=VALUE", ...)
_ENTRIES: dict = {}
_LOCK = threading.Lock()


def declared_macros(name: str) -> set:
    """The macros kernel ``name``'s source declares as tunables: each
    ``#ifndef NAME`` of its source file (the shared headers excluded)."""
    with open(os.path.join(CSRC, KERNELS[name][0])) as f:
        return set(re.findall(r"^\s*#\s*ifndef\s+(\w+)", f.read(), re.M))


def _declared(name: str, defines) -> tuple:
    """``defines`` as a tuple; ValueError naming each macro that kernel
    ``name``'s source does not declare."""
    defines = tuple(defines)
    unknown = [d.split("=", 1)[0] for d in defines
               if d.split("=", 1)[0] not in declared_macros(name)]
    if unknown:
        raise ValueError(f"{name}: {KERNELS[name][0]} declares no "
                         f"{', '.join(unknown)}")
    return defines


def set_defines(name: str, defines=()):
    """From now on build and load kernel ``name`` with these ``-D`` macros
    ("NAME=VALUE" strings overriding the tunables its source declares);
    () restores the source's defaults. Raises ValueError for a macro the
    source does not declare: such a build would be the default kernel under
    another name."""
    defines = _declared(name, defines)
    with _LOCK:
        _DEFINES[name] = defines
        _ENTRIES.pop(name, None)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    GEOMETRY_LAUNCHES.clear()


def launch_counts() -> tuple:
    """A copy of both counters, (LAUNCHES, GEOMETRY_LAUNCHES). The counters
    are Python integers that ``check`` adds to, so the replay of a CUDA
    graph counts nothing by itself: ``models.captured`` takes the counts
    before and after a capture (``launch_delta``), puts the earlier ones
    back (``set_launch_counts``: a capture launches nothing) and adds the
    difference at every replay (``add_launches``)."""
    return dict(LAUNCHES), dict(GEOMETRY_LAUNCHES)


def set_launch_counts(counts: tuple):
    """Both counters as ``launch_counts`` gave them, in place."""
    launches, geometry = counts
    LAUNCHES.update(launches)
    GEOMETRY_LAUNCHES.clear()
    GEOMETRY_LAUNCHES.update(geometry)


def launch_delta(before: tuple, after: tuple) -> tuple:
    """The launches counted between two ``launch_counts``, as
    ({name: n}, {geometry key: n}) with the keys that moved."""
    return tuple({k: n - old.get(k, 0) for k, n in new.items()
                  if n != old.get(k, 0)}
                 for old, new in zip(before, after))


def add_launches(delta: tuple):
    """Count a ``launch_delta`` once more (one replay of what it counted)."""
    launches, geometry = delta
    for k, n in launches.items():
        LAUNCHES[k] += n
    for k, n in geometry.items():
        GEOMETRY_LAUNCHES[k] = GEOMETRY_LAUNCHES.get(k, 0) + n


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str, defines=None) -> str:
    """The library of kernel ``name`` built with ``defines`` (default: the
    ones ``set_defines`` gave it)."""
    defines = _DEFINES.get(name, ()) if defines is None else tuple(defines)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    src = KERNELS[name][0]
    for path in [os.path.join(CSRC, src), *headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(names=None, variants=()) -> dict:
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc process per library, all started together; ``variants``:
    further (name, defines) pairs to build beside them (a probe's
    alternatives of one source). Returns each compiled library's compiler
    output (register and shared-memory use), keyed by kernel name (and the
    defines of a variant)."""
    names = list(KERNELS) if names is None else list(names)
    jobs = [(name, _DEFINES.get(name, ())) for name in names]
    jobs += [(name, _declared(name, defs)) for name, defs in variants]
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, seen = {}, set()
    for name, defines in jobs:
        so = library_path(name, defines)
        if os.path.exists(so) or so in seen:
            continue
        seen.add(so)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
               "-o", tmp, os.path.join(CSRC, KERNELS[name][0])]
        key = name if not defines else f"{name} {' '.join(defines)}"
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, so)  # atomic: a reader never sees a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def entry(name: str):
    """The C entry of kernel ``name``, building its library first if needed."""
    with _LOCK:
        fn = _ENTRIES.get(name)
        if fn is None:
            build([name])
            _, sym, argtypes = KERNELS[name]
            fn = getattr(ctypes.CDLL(library_path(name)), sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _ENTRIES[name] = fn
    return fn


def check(name: str, rc: int, counter: str | None = None, geometry=None):
    """Raise if the launch of kernel ``name`` failed; else count it under
    ``counter`` (default ``name``) and, given ``geometry`` (N, K, warps,
    rows_per_warp, B), in GEOMETRY_LAUNCHES."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[counter or name] += 1
    if geometry is not None:
        key = (counter or name, *geometry)
        GEOMETRY_LAUNCHES[key] = GEOMETRY_LAUNCHES.get(key, 0) + 1
