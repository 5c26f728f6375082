"""The hand-written CUDA kernels of the port and their wrappers: the
counterpart of ``openvqe_tpu/sim/pallas_kernels.py`` (per-group route,
n <= 19), of ``openvqe_tpu/sim/streaming.py``'s default path (bucketed
route, n >= 20), its per-group path (OVQE_STREAM_FUSE=0), its hoisted
expectation (OVQE_EXP_HOIST=1) and its two ADAPT pool-screen kernels.

===================  ==================================================
wrapper              replaces
===================  ==================================================
``rot_sweep``        ``pallas_kernels.py::_rot_kernel``
``expectation``      ``pallas_kernels.py::_expect_kernel``
``ham_apply``        ``pallas_kernels.py::_ham_kernel``
``adjoint_sweep``    ``pallas_kernels.py::_adjoint_kernel``
``rot_fused``        ``streaming.py::_rot_fused_kernel``
``adjoint_fused``    ``streaming.py::_adj_fused_kernel``
``ham_bucketed``     ``streaming.py::_ham_bucket_kernel``
``expect_bucketed``  ``streaming.py::_expect_bucket_kernel``
``expect_hoisted``   ``streaming.py::_expect_hoist_kernel``
``rot_stream``       ``streaming.py::_rot_stream_kernel``
``adjoint_stream``   ``streaming.py::_adj_stream_kernel``
``ham_stream``       ``streaming.py::_ham_stream_kernel``
``expect_stream``    ``streaming.py::_expect_stream_kernel``
``pool_overlap``     ``streaming.py::_pool_stream_kernel``
``pool_bucketed``    ``streaming.py::_pool_bucket_kernel``
===================  ==================================================

The sources are ``csrc/grouped_kernels.cu``, ``csrc/streaming_kernels.cu``,
``csrc/stream_group_kernels.cu`` and ``csrc/pool_kernels.cu`` (what bounds
each kernel and what its design does about it is noted there; shared
helpers in ``csrc/common.cuh``).  ``build()`` compiles each with ``nvcc``
for ``sm_90a`` into its own shared library under ``build/`` at the root of
the checkout on first use, all compilers running at once, and the
libraries are bound with ``ctypes``.

Wrapper rules: a tensor on the CPU goes to the plain PyTorch version
(``sim/grouped.py``, ``sim/streaming.py``); a CUDA tensor goes to the
kernel, or the wrapper raises.  There is no fallback.  Per-group operands
are those of ``sim/convert.py``: for the H-apply and the expectation a
``convert.HamOperands``; for the sweeps a ``convert.SeqOperands`` with
angles (G,) float32; bucketed operands are a ``streaming.BucketOperands``
with angles (B, gcap) float32; per-group streaming operands a
``streaming.GroupOperands`` with angles (G,) float32; for the per-group
pool overlap a ``convert.PoolOperands``; pool-overlap rows are (G, 2) or
(B, gcap, 2) float32 (re, im); state planes are (2, 2^n) float32, all
contiguous and on one device.  Outputs are allocated with ``torch.empty``
and the kernels run on the current stream.  ``LAUNCHES`` counts, per
wrapper, the calls that launched the kernel.  ``rot_sweep`` and
``adjoint_sweep`` (A1, C7) run one launch per sweep, the state held in the
shared memory of one thread-block cluster (``cluster_size`` picks its
blocks from n; a cluster the card refuses raises); where one cluster
cannot hold the states (A1 at n >= 19, C7 at n >= 18) their per-group
kernels replay one CUDA graph per operand set, as ``rot_stream`` and
``adjoint_stream`` (A2, C8) do on every call.  ``rot_sweep``, ``adjoint_sweep``, ``rot_fused``, ``adjoint_fused``,
``rot_stream`` and ``adjoint_stream`` compute one field per pair and take
only operands that carry the odd-Y certificate (``SeqOperands.odd_y``,
``BucketOperands.odd_y``, ``GroupOperands.odd_y``), on either device:
without it they raise ``ValueError``.  The kernels that stage states with
16-byte loads (``rot_sweep`` and ``adjoint_sweep`` on a cluster,
``rot_fused``, ``adjoint_fused``, ``ham_bucketed``, ``expect_bucketed``,
``expect_hoisted``) refuse a state on the card whose data is not 16-byte
aligned.  ``grouped_attributes``, ``ham_attributes``,
``expect_attributes``, ``sweep_attributes``, ``bucket_attributes``,
``stream_group_attributes``, ``expect_stream_attributes``,
``ham_stream_attributes`` and ``pool_attributes`` report how A1 / C7, B4,
D10, A3 / C9, B6 / D12 / D13, A2 / C8, D11, B5 and E14 / E15 launch
(registers, spills, shared memory, resident blocks per SM or clusters);
``cluster_floor`` runs the barrier floor of the cluster sweeps.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

from . import convert
from . import grouped as gr
from . import streaming as st

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"grouped": CSRC / "grouped_kernels.cu",
           "streaming": CSRC / "streaming_kernels.cu",
           "stream_group": CSRC / "stream_group_kernels.cu",
           "pool": CSRC / "pool_kernels.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

KERNELS = ("rot_sweep", "expectation", "ham_apply", "adjoint_sweep",
           "rot_fused", "adjoint_fused", "ham_bucketed", "expect_bucketed",
           "expect_hoisted", "rot_stream", "adjoint_stream", "ham_stream",
           "expect_stream", "pool_overlap", "pool_bucketed")
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
build_log = ""          # nvcc's output (-Xptxas -v) of the last build

_libs: Dict[str, ctypes.CDLL] = {}
_threads = 0            # block size of the grouped kernels
_sg_threads = 0         # block size of the per-group streaming kernels


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    """The library of a source, named by the content of the source and of
    the headers beside it (``common.cuh``)."""
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"libovqe_{name}_{h.hexdigest()[:12]}.so"


def build() -> Dict[str, Path]:
    """Compile the kernel sources (once per content of each source and the
    shared header), one nvcc per source, all started together; return the
    shared libraries by name."""
    global build_log
    libs = {name: _lib_path(name) for name in SOURCES}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"[{SOURCES[name].name}]\n{out}")
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name].name} ({proc.returncode})")
        else:
            os.replace(tmp, todo[name])
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{build_log}")
    return libs


_SIGNATURES = {
    "grouped": {
        "ovqe_rot_sweep": "PPIIPPPPPIIIP",
        "ovqe_adjoint_sweep": "PPPPIIPPPPPIIIPIPP",
        "ovqe_sweep_group_graph": "ILPPPPIIIIPP",
        "ovqe_graph_replay": "PPPP",
        "ovqe_graph_destroy": "P",
        "ovqe_sweep_attrs": "IIIIIP",
        "ovqe_sweep_group_attrs": "IIP",
        "ovqe_cluster_floor": "IIIPP",
        "ovqe_ham_apply": "PPLPPPPPIIIIP",
        "ovqe_walk_attrs": "IIIIP",
        "ovqe_expectation": "PLPPPPPIIIIPIPP",
        "ovqe_block_threads": "",
    },
    "streaming": {
        "ovqe_rot_fused": "PLIPPPPPPIIIIP",
        "ovqe_adjoint_fused": "PPLIPPPPPPIIIIPPP",
        "ovqe_ham_bucketed": "PPPLIPPPPPPIIIIP",
        "ovqe_expect_bucketed": "PLIPPPPPPIIIIIPPP",
        "ovqe_expect_hoisted": "PLIPPPPPPIIIIPPP",
        "ovqe_sweep_attrs": "IIIIP",
        "ovqe_bucket_attrs": "IIIIP",
    },
    "stream_group": {
        "ovqe_rot_stream": "LPPPPIIIIIPP",
        "ovqe_rot_stream_graph": "LPPPPIIIIIPP",
        "ovqe_adjoint_stream": "LPPPPIIIIIPP",
        "ovqe_adjoint_stream_graph": "LPPPPIIIIIPP",
        "ovqe_graph_replay": "PPPP",
        "ovqe_graph_destroy": "P",
        "ovqe_stream_group_attrs": "IIIP",
        "ovqe_ham_stream": "PPPLPPPPPIIIIP",
        "ovqe_ham_stream_attrs": "IIIIP",
        "ovqe_expect_stream": "PLPPPPPIIIIIPIPP",
        "ovqe_expect_stream_attrs": "IIIP",
        "ovqe_sg_block_threads": "",
    },
    "pool": {
        "ovqe_pool_overlap": "PPLPPPPPIIIPIPP",
        "ovqe_pool_bucketed": "PPLIPPPPPPIIIIPPP",
        "ovqe_pool_attrs": "IIIIIIP",
        "ovqe_pool_blocks": "L",
    },
}


def _load(name: str = "grouped") -> ctypes.CDLL:
    global _threads, _sg_threads
    if not _libs:
        types = {"P": ctypes.c_void_p, "I": ctypes.c_int,
                 "L": ctypes.c_longlong}
        for lib_name, path in build().items():
            lib = ctypes.CDLL(str(path))
            for fn_name, sig in _SIGNATURES[lib_name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = [types[c] for c in sig]
                fn.restype = ctypes.c_int
            _libs[lib_name] = lib
        _threads = _libs["grouped"].ovqe_block_threads()
        _sg_threads = _libs["stream_group"].ovqe_sg_block_threads()
    return _libs[name]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _state(name: str, psi: torch.Tensor) -> int:
    N = psi.shape[-1] if psi.dim() == 2 else 0
    if psi.dim() != 2 or psi.shape[0] != 2 or N < 2 or N & (N - 1) \
            or N > (1 << 30):
        raise ValueError(f"{name} must have shape (2, 2^n), 1 <= n <= 30; "
                         f"got {tuple(psi.shape)}")
    _check(name, psi, torch.float32, (2, N), psi.device)
    return N


def _groups(psi, x, z, coefs, angles=None):
    G, K = x.shape[0], (z.shape[1] if z.dim() == 2 else -1)
    _check("x", x, torch.int32, (G,), psi.device)
    _check("z", z, torch.int32, (G, K), psi.device)
    for i, c in enumerate(coefs):
        _check(f"coef{i}", c, torch.float32, (G, K), psi.device)
    if angles is not None:
        _check("angles", angles, torch.float32, (G,), psi.device)
    return G, K


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(name: str, fn, *args) -> None:
    """Call a C entry point (tensors go as device pointers), raise on its
    cudaGetLastError() code, and count the launch."""
    rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def _fmode(fmode: int) -> int:
    if fmode not in (0, 1, 2):
        raise ValueError(f"fmode must be 0, 1 or 2, got {fmode}")
    return fmode


# ------------------------------------------- per-group route (n <= 19)

_SWEEP_PLANES = {"rot_sweep": 2, "adjoint_sweep": 4}    # psi; p and lambda
SLICE_BYTES = 1 << 17   # the most state one block of a cluster holds
MAX_CLUSTER = 16        # GR_MAX_CLUSTER: the largest cluster the card runs


def cluster_size(name: str, n: int) -> int:
    """Blocks of the thread-block cluster that holds the states of A1
    (``rot_sweep``) or C7 (``adjoint_sweep``) at 2^n amplitudes: 1 up to
    n = 11; above, the most blocks, up to 16, that keep one pair a thread
    (2^10 amplitudes a block), which ran fastest on an H100 at n = 12, 13,
    14 and 16 (``scripts/torch_cluster_variants.py``); 0 where 16 blocks
    of ``SLICE_BYTES`` cannot hold the states (A1 at n >= 19, C7 at
    n >= 18: the per-group kernels, replayed as one CUDA graph)."""
    if name not in _SWEEP_PLANES:
        raise ValueError(f"not a per-group sweep: {name}")
    if n <= 11:
        return 1
    if _SWEEP_PLANES[name] * 4 << n > MAX_CLUSTER * SLICE_BYTES:
        return 0
    return min(MAX_CLUSTER, 1 << (n - 10))


def _seq(psi: torch.Tensor, so: convert.SeqOperands) -> int:
    """Check a rotation operand set against the state; return N."""
    N = _state("psi", psi)
    if N != 1 << so.n:
        raise ValueError(f"state of 2^{N.bit_length() - 1} amplitudes for "
                         f"groups built for n = {so.n}")
    G, Kc = so.G, so.K
    _check("x", so.x, torch.int32, (G,), psi.device)
    _check("z_pair", so.z_pair, torch.int32, (G, Kc), psi.device)
    _check("s", so.s, torch.float32, (G, Kc), psi.device)
    _check("k_live", so.k_live, torch.int32, (G,), psi.device)
    return N


_CLUSTERS: Dict[tuple, int] = {}   # max active clusters per instance


def _cluster_fits(name: str, so: convert.SeqOperands, C: int) -> None:
    """Raise unless the card can run ``name``'s cluster of C blocks on
    ``so`` (cudaOccupancyMaxActiveClusters, asked once per instance)."""
    key = (name, torch.cuda.current_device(), so.n, C, so.K, so.G)
    if key not in _CLUSTERS:
        _CLUSTERS[key] = _sweep_attrs(name, so, C)["max_active_clusters"]
    if _CLUSTERS[key] < 1:
        raise RuntimeError(f"{name}: the card cannot run a cluster of {C} "
                           f"blocks at n = {so.n}")


def _rot_cluster(psi, angles, so: convert.SeqOperands, fmode: int, C: int):
    """A1 in one launch on a cluster of C blocks (``cluster_size``'s)."""
    _aligned(psi)
    _cluster_fits("rot_sweep", so, C)
    out = torch.empty_like(psi)
    _launch("rot_sweep", _load().ovqe_rot_sweep, psi, out, so.n,
            C.bit_length() - 1, so.x, so.z_pair, so.s, so.k_live, angles,
            so.G, so.K, fmode, _stream(psi))
    return out


def _adjoint_cluster(p, lam, angles, so: convert.SeqOperands, fmode: int,
                     C: int):
    """C7 in one launch on a cluster of C blocks, then its row sums."""
    _aligned(p, lam)
    _cluster_fits("adjoint_sweep", so, C)
    N = 1 << so.n
    p_out, l_out = torch.empty_like(p), torch.empty_like(lam)
    nb = max(1, N // 256)
    partials = torch.empty((so.G, nb), dtype=torch.float32, device=p.device)
    gts = torch.empty(so.G, dtype=torch.float32, device=p.device)
    _launch("adjoint_sweep", _load().ovqe_adjoint_sweep, p, lam, p_out,
            l_out, so.n, C.bit_length() - 1, so.x, so.z_pair, so.s,
            so.k_live, angles, so.G, so.K, fmode, partials, nb, gts,
            _stream(p))
    return p_out, l_out, gts


def _sweep_graph(name: str, so: convert.SeqOperands, N: int, fmode: int,
                 nb: int, stream: int) -> "_Graph":
    """The per-group route's graph of ``so`` for this sweep, state size,
    field mode and stream, captured on first use and kept in
    ``so.graphs`` (keyed by so's device pointers too, as C8's)."""
    key = (name, N, fmode, stream, so.x.data_ptr(), so.z_pair.data_ptr(),
           so.s.data_ptr(), so.k_live.data_ptr())
    if key not in so.graphs:
        so.graphs[key] = _Graph(
            "grouped", "ovqe_sweep_group_graph", so.x.device,
            int(name == "adjoint_sweep"), N, so.x.data_ptr(),
            so.z_pair.data_ptr(), so.s.data_ptr(), so.k_live.data_ptr(),
            so.G, so.K, fmode, nb)
    return so.graphs[key]


def rot_sweep(psi, angles, so: convert.SeqOperands, fmode: int):
    """prod_g Rot(B_g) psi, groups of ``so`` in order; B_g(j) = angles[g]
    F_g(j).  On the card one launch walks every group with the state held
    in one thread-block cluster (``cluster_size``; the state 16-byte
    aligned); beyond one cluster the per-group kernels replay one CUDA graph
    per operand set (one host thread at a time per ``so``, as C8's).
    ``so`` must carry the odd-Y certificate (``so.odd_y``) on either
    device."""
    _odd_y(so)
    if psi.device.type == "cpu":
        return gr.rot_sweep_ref(psi, angles, so.x, so.z, so.s, fmode)
    N = _seq(psi, so)
    _check("angles", angles, torch.float32, (so.G,), psi.device)
    fmode = _fmode(fmode)
    if not so.G:
        return psi.clone()
    C = cluster_size("rot_sweep", so.n)
    if C:
        return _rot_cluster(psi, angles, so, fmode, C)
    out, stream = psi.clone(), _stream(psi)
    _sweep_graph("rot_sweep", so, N, fmode, 0, stream).replay(
        "rot_sweep", (out.data_ptr(), 0, angles.data_ptr(), 0, 0), stream)
    return out


def adjoint_sweep(p, lam, angles, so: convert.SeqOperands, fmode: int):
    """Reversible adjoint over the groups of ``so`` in reverse order;
    returns (p_prev, lam_prev, gts) with gts (G,) the per-group gradient
    entries in forward group order.  Routes as ``rot_sweep`` (one cluster
    launch and its row sums, or one graph beyond one cluster); ``so`` must
    carry the odd-Y certificate on either device."""
    _odd_y(so)
    if p.device.type == "cpu":
        return gr.adjoint_sweep_ref(p, lam, angles, so.x, so.z, so.s, fmode)
    N = _seq(p, so)
    _check("lam", lam, torch.float32, (2, N), p.device)
    _check("angles", angles, torch.float32, (so.G,), p.device)
    fmode = _fmode(fmode)
    if not so.G:
        return p.clone(), lam.clone(), torch.empty(0, device=p.device)
    C = cluster_size("adjoint_sweep", so.n)
    if C:
        return _adjoint_cluster(p, lam, angles, so, fmode, C)
    p_out, l_out = p.clone(), lam.clone()
    nb = N // 256
    partials = torch.empty((so.G, nb), dtype=torch.float32, device=p.device)
    gts = torch.empty(so.G, dtype=torch.float32, device=p.device)
    stream = _stream(p)
    _sweep_graph("adjoint_sweep", so, N, fmode, nb, stream).replay(
        "adjoint_sweep", (p_out.data_ptr(), l_out.data_ptr(),
                          angles.data_ptr(), partials.data_ptr(),
                          gts.data_ptr()), stream)
    return p_out, l_out, gts


def _sweep_attrs(name: str, so: convert.SeqOperands, C: int
                 ) -> Dict[str, int]:
    out = (ctypes.c_int * 6)()
    rc = _load().ovqe_sweep_attrs(int(name == "adjoint_sweep"), so.n,
                                  C.bit_length() - 1, so.K, so.G,
                                  ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"grouped_attributes({name}): CUDA error {rc}")
    keys = ("registers", "local_bytes", "smem_bytes", "threads", "per",
            "max_active_clusters")
    return {"route": "cluster", "cluster": C, **dict(zip(keys, list(out)))}


def grouped_attributes(name: str, so: convert.SeqOperands
                       ) -> Dict[str, object]:
    """How ``rot_sweep`` or ``adjoint_sweep`` launches on ``so``: the route
    (``cluster`` or ``graph``), the cluster's blocks C (``cluster_size``'s;
    0 on the graph route), registers and local bytes per
    thread (the stack frame of sincosf's slow path and any spill), shared
    memory per block (dynamic on the cluster route, static on the graph
    route), threads per block, pairs per thread, and the card's max active
    clusters of that shape (cluster route) or its resident blocks per SM
    (graph route)."""
    C = cluster_size(name, so.n)
    if C:
        return _sweep_attrs(name, so, C)
    out = (ctypes.c_int * 4)()
    rc = _load().ovqe_sweep_group_attrs(int(name == "adjoint_sweep"), so.K,
                                        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"grouped_attributes({name}): CUDA error {rc}")
    return {"route": "graph", "cluster": 0, "registers": out[0],
            "local_bytes": out[1], "smem_bytes": out[2], "threads": 256,
            "per": 8, "blocks_per_sm": out[3]}


def cluster_floor(G: int, C: int, smem_bytes: int,
                  device) -> torch.Tensor:
    """One launch of the barrier floor of the cluster sweeps: a cluster of
    C blocks of the sweeps' threads with ``smem_bytes`` of shared memory
    each doing G dependent steps of one cluster barrier, each with one
    dependent distributed-shared-memory read.  Returns its (C,) output (G
    in every entry).  Not a ported kernel: it is not counted in
    ``LAUNCHES``."""
    out = torch.empty(C, dtype=torch.float32, device=device)
    rc = _load().ovqe_cluster_floor(G, C.bit_length() - 1, smem_bytes,
                                    out.data_ptr(), _stream(out))
    if rc != 0:
        raise RuntimeError(f"cluster_floor: CUDA error {rc}")
    return out


HAM_PER = 2             # amplitudes a thread of B4 (ham_apply): the
                        # fastest at H8 on an H100, level at H6 and BeH2
HAM_THREADS = 128       # GR_HAM_THREADS of csrc/grouped_kernels.cu


def ham_per(N: int) -> int:
    """B4's amplitudes per thread on a state of N amplitudes: ``HAM_PER``,
    or the largest power of two below it whose blocks of ``HAM_THREADS``
    the state fills (1, with idle threads, below ``HAM_THREADS``)."""
    per = HAM_PER
    while per > 1 and per * HAM_THREADS > N:
        per //= 2
    return per


def _ham_ops(psi: torch.Tensor, ho: convert.HamOperands) -> int:
    """Check B4's operands against the state; return N."""
    N = _state("psi", psi)
    _groups(psi, ho.x, ho.z, (ho.a_re, ho.a_im))
    _check("k_live", ho.k_live, torch.int32, (ho.G,), psi.device)
    return N


def _ham(psi, ho: convert.HamOperands, per: int):
    """B4's launch at ``per`` amplitudes a thread (``ham_per``'s on the
    entry point's path)."""
    N = _ham_ops(psi, ho)
    out = torch.empty_like(psi)
    _launch("ham_apply", _load().ovqe_ham_apply, psi, out, N, ho.x, ho.z,
            ho.a_re, ho.a_im, ho.k_live, ho.G, ho.K, int(ho.real), per,
            _stream(psi))
    return out


def ham_apply(psi, ho: convert.HamOperands):
    """sum_g W_g(j) psi[j ^ x_g] over the groups of ``ho`` (x = 0 groups
    carry the diagonal; the identity offset is the caller's).  On the card
    one launch, ``ham_per(N)`` amplitudes a thread; each group adds its
    ``ho.k_live`` terms, and W_im only where ``ho.real`` is false."""
    if psi.device.type == "cpu":
        return gr.ham_apply_ref(psi, *ho.args())
    N = _ham_ops(psi, ho)
    if not ho.G:
        return torch.zeros_like(psi)
    return _ham(psi, ho, ham_per(N))


_WALK_KEYS = ("registers", "local_bytes", "smem_bytes", "threads",
              "blocks_per_sm", "k_tile", "per")


def _walk_attrs(name: str, attrs, per: int, ops) -> Dict[str, int]:
    """The ``_WALK_KEYS`` of a walk instance from its C entry ``attrs(per,
    K, real, out)``."""
    out = (ctypes.c_int * 7)()
    rc = attrs(per, ops.K, int(ops.real), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    return dict(zip(_WALK_KEYS, list(out)))


def ham_attributes(ho: convert.HamOperands, n: int) -> Dict[str, int]:
    """How ``ham_apply`` launches on ``ho`` at a 2^n state: registers and
    local (spill) bytes per thread, dynamic shared memory and threads per
    block, resident blocks per SM, the compiled term tile and the
    amplitudes per thread (the instance is chosen by PER, K and
    ``ho.real``)."""
    return _walk_attrs("ham_attributes",
                       functools.partial(_load().ovqe_walk_attrs, 0),
                       ham_per(1 << n), ho)


EXPECT_PER = 2          # amplitudes a thread of D10 (expectation): the
                        # fastest at H8, H6 and BeH2 on an H100
EXPECT_THREADS = 128    # GR_EXP_THREADS of csrc/grouped_kernels.cu


def expect_per(N: int) -> int:
    """D10's amplitudes per thread on a state of N amplitudes:
    ``EXPECT_PER``, or the largest power of two below it whose blocks of
    ``EXPECT_THREADS`` the state fills (1, with idle threads, below
    ``EXPECT_THREADS``)."""
    per = EXPECT_PER
    while per > 1 and per * EXPECT_THREADS > N:
        per //= 2
    return per


def _expect(psi, ho: convert.HamOperands, per: int):
    """D10's launch at ``per`` amplitudes a thread (``expect_per``'s on
    the entry point's path)."""
    N = _ham_ops(psi, ho)
    lib = _load()               # builds and reads _threads
    nb = -(-N // _threads)
    partials = torch.empty(nb, dtype=torch.float32, device=psi.device)
    out = torch.empty(1, dtype=torch.float32, device=psi.device)
    _launch("expectation", lib.ovqe_expectation, psi, N, ho.x, ho.z,
            ho.a_re, ho.a_im, ho.k_live, ho.G, ho.K, int(ho.real), per,
            partials, nb, out, _stream(psi))
    return out[0]


def expectation(psi, ho: convert.HamOperands):
    """sum_g sum_j Re(conj(psi_j) W_g(j) psi_{j^x_g}) over the groups of
    ``ho`` as a 0-dim tensor (the identity offset is the caller's).  On the
    card one launch and its fixed-order sum, ``expect_per(N)`` amplitudes
    a thread; each group adds its ``ho.k_live`` terms, and W_im only where
    ``ho.real`` is false."""
    if psi.device.type == "cpu":
        return gr.expectation_ref(psi, *ho.args())
    N = _ham_ops(psi, ho)
    if not ho.G:
        return torch.zeros((), dtype=psi.dtype, device=psi.device)
    return _expect(psi, ho, expect_per(N))


def expect_attributes(ho: convert.HamOperands, n: int) -> Dict[str, int]:
    """How ``expectation`` launches on ``ho`` at a 2^n state (the keys of
    ``ham_attributes``)."""
    return _walk_attrs("expect_attributes",
                       functools.partial(_load().ovqe_walk_attrs, 1),
                       expect_per(1 << n), ho)


# ------------------------------------------------ bucketed (streaming) route

def _buckets(psi: torch.Tensor, bo: st.BucketOperands,
             coefs: tuple) -> int:
    """Check a bucket operand set against the state; return N."""
    N = _state("psi", psi)
    if N != 1 << bo.n:
        raise ValueError(f"state of 2^{N.bit_length() - 1} amplitudes for "
                         f"buckets built for n = {bo.n}")
    lo, hi = st.CUDA_CHUNK_BITS
    if not lo <= bo.chunk_bits <= min(hi, bo.n - 1):
        raise ValueError(f"the CUDA kernels take chunk_bits in [{lo}, "
                         f"{min(hi, bo.n - 1)}], got {bo.chunk_bits}")
    B, gcap, Kc = bo.B, bo.gcap, bo.K
    if B == 0:
        raise ValueError("empty bucket set")
    _check("x_hi", bo.x_hi, torch.int32, (B,), psi.device)
    _check("x_lo", bo.x_lo, torch.int32, (B, gcap), psi.device)
    _check("act", bo.act, torch.int32, (B, gcap), psi.device)
    _check("k_live", bo.k_live, torch.int32, (B, gcap), psi.device)
    _check("z", bo.z, torch.int32, (B, gcap, Kc), psi.device)
    for i, c in enumerate(coefs):
        _check(f"coef{i}", c, torch.float32, (B, gcap, Kc), psi.device)
    return N


def _in_place(psi, out, inplace: bool):
    """A plain version's result, written into psi when ``inplace``."""
    return psi.copy_(out) if inplace else out


def _odd_y(ops) -> None:
    """``ops`` (``BucketOperands``, ``GroupOperands`` or ``SeqOperands``)
    must carry the odd-Y certificate."""
    if not ops.odd_y:
        raise ValueError(
            "rotation operands without the odd-Y certificate "
            "(streaming.Buckets.odd_y, GroupOperands.odd_y, "
            "SeqOperands.odd_y): the kernel computes one field per pair and "
            "needs F(j ^ x) = -F(j)")


def _aligned(*states: torch.Tensor) -> None:
    """The sweeps and the bucketed H kernels stage states with 16-byte
    (float4) loads."""
    for t in states:
        if t.data_ptr() % 16:
            raise ValueError("the kernel takes states whose data is 16-byte "
                             "aligned")


def rot_fused(psi, ang, bo: st.BucketOperands, fmode: int,
              inplace: bool = False):
    """The rotation sweep over the runs of ``bo`` in order (one launch per
    run); ang (B, gcap) holds -theta[op] per slot.  ``inplace`` rotates
    psi itself (16-byte aligned on the card) and returns it (no second
    state).  ``bo`` must carry the odd-Y certificate (``bo.odd_y``) on
    either device."""
    _odd_y(bo)
    if psi.device.type == "cpu":
        return _in_place(psi, st.rot_fused_ref(psi, ang, bo, fmode), inplace)
    N = _buckets(psi, bo, (bo.coef,))
    _check("ang", ang, torch.float32, (bo.B, bo.gcap), psi.device)
    lib = _load("streaming")
    out = psi if inplace else torch.empty_like(psi).copy_(psi)
    _aligned(out)
    _launch("rot_fused", lib.ovqe_rot_fused, out, N, bo.chunk_bits, bo.x_hi,
            bo.x_lo, bo.act, bo.z, bo.coef, ang, bo.B, bo.gcap, bo.K,
            _fmode(fmode), _stream(psi))
    return out


def adjoint_fused(p, lam, ang, bo: st.BucketOperands, fmode: int):
    """Reversible adjoint over the runs of the REVERSED sequence in ``bo``;
    returns (p_prev, lam_prev, gts) with gts (B, gcap) the per-slot
    gradient entries (0 in padding slots).  ``bo`` must carry the odd-Y
    certificate (``bo.odd_y``) on either device."""
    _odd_y(bo)
    if p.device.type == "cpu":
        return st.adjoint_fused_ref(p, lam, ang, bo, fmode)
    N = _buckets(p, bo, (bo.coef,))
    _check("lam", lam, torch.float32, (2, N), p.device)
    _check("ang", ang, torch.float32, (bo.B, bo.gcap), p.device)
    lib = _load("streaming")
    p_out, l_out = torch.empty_like(p), torch.empty_like(lam)
    p_out.copy_(p)
    l_out.copy_(lam)
    _aligned(p_out, l_out)
    nblk = N >> (bo.chunk_bits + 1)
    partials = torch.empty((bo.B * bo.gcap, nblk), dtype=torch.float32,
                           device=p.device)
    gts = torch.empty((bo.B, bo.gcap), dtype=torch.float32, device=p.device)
    _launch("adjoint_fused", lib.ovqe_adjoint_fused, p_out, l_out, N,
            bo.chunk_bits, bo.x_hi, bo.x_lo, bo.act, bo.z, bo.coef, ang,
            bo.B, bo.gcap, bo.K, _fmode(fmode), partials, gts, _stream(p))
    return p_out, l_out, gts


SWEEP_PER = 8           # SW_PER of csrc/streaming_kernels.cu: pairs per
                        # thread and group of A3 and C9, 2^cb / 8 threads


def sweep_attributes(name: str, bo: st.BucketOperands) -> Dict[str, int]:
    """How ``rot_fused`` or ``adjoint_fused`` launches on ``bo``: resident
    blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers and local (spill) bytes per thread, dynamic shared memory
    per block, threads per block, and the compile-time and padded K."""
    if name not in ("rot_fused", "adjoint_fused"):
        raise ValueError(f"not a sweep kernel: {name}")
    out = (ctypes.c_int * 7)()
    rc = _load("streaming").ovqe_sweep_attrs(
        int(name == "adjoint_fused"), bo.K, bo.chunk_bits, bo.gcap,
        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"sweep_attributes({name}): CUDA error {rc}")
    keys = ("blocks_per_sm", "registers", "spill_bytes", "smem_bytes",
            "threads", "k_compiled", "k_padded")
    return dict(zip(keys, list(out)))


_BUCKET_KERNELS = ("ham_bucketed", "expect_bucketed", "expect_hoisted")


def bucket_attributes(name: str, bo: st.BucketOperands) -> Dict[str, int]:
    """How ``ham_bucketed``, ``expect_bucketed`` or ``expect_hoisted``
    launches on ``bo`` (for ``expect_hoisted`` the rows' operands,
    ``HoistOperands.bo``): resident blocks per SM, registers and local
    (spill) bytes per thread, dynamic shared memory per block, threads per
    block and the compiled term tile (the instance is chosen by chunk, K
    and ``bo.real``)."""
    if name not in _BUCKET_KERNELS:
        raise ValueError(f"not a bucketed H kernel: {name}")
    out = (ctypes.c_int * 6)()
    rc = _load("streaming").ovqe_bucket_attrs(
        _BUCKET_KERNELS.index(name), bo.K, int(bo.real), bo.chunk_bits,
        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"bucket_attributes({name}): CUDA error {rc}")
    keys = ("blocks_per_sm", "registers", "spill_bytes", "smem_bytes",
            "threads", "k_tile")
    return dict(zip(keys, list(out)))


def ham_bucketed(psi, acc, bo: st.BucketOperands):
    """acc + (the groups of one K class) |psi> in one launch; acc None
    counts as zero."""
    if psi.device.type == "cpu":
        return st.ham_bucketed_ref(psi, acc, bo)
    N = _buckets(psi, bo, (bo.coef, bo.coef_im))
    if acc is not None:
        _check("acc", acc, torch.float32, (2, N), psi.device)
    _aligned(psi)
    lib = _load("streaming")
    out = torch.empty_like(psi)
    _launch("ham_bucketed", lib.ovqe_ham_bucketed, psi, acc, out, N,
            bo.chunk_bits, bo.x_hi, bo.x_lo, bo.k_live, bo.z, bo.coef,
            bo.coef_im, bo.B, bo.gcap, bo.K, int(bo.real), _stream(psi))
    return out


def expect_bucketed(psi, bo: st.BucketOperands, herm: bool = False):
    """The groups of one K class contracted with conj(psi): a 0-dim
    tensor.  ``herm`` counts each pair across chunks once, doubled; only
    where the caller certifies every group Hermitian as an operator
    (``streaming.grouped_hermitian_operator``)."""
    if psi.device.type == "cpu":
        return st.expect_bucketed_ref(psi, bo, herm)
    N = _buckets(psi, bo, (bo.coef, bo.coef_im))
    _aligned(psi)
    lib = _load("streaming")
    partials = torch.empty(N >> bo.chunk_bits, dtype=torch.float64,
                           device=psi.device)
    out = torch.empty(1, dtype=torch.float32, device=psi.device)
    _launch("expect_bucketed", lib.ovqe_expect_bucketed, psi, N,
            bo.chunk_bits, bo.x_hi, bo.x_lo, bo.k_live, bo.z, bo.coef,
            bo.coef_im, bo.B, bo.gcap, bo.K, int(bo.real), int(bool(herm)),
            partials, out, _stream(psi))
    return out[0]


def expect_hoisted(psi, ho: st.HoistOperands):
    """The Hermitian expectation over hoisted rows (``streaming.
    hoist_bucket_args``): a 0-dim tensor, the value of
    ``expect_bucketed(herm=True)`` on the same groups, one launch per row
    set.  The caller certifies every group Hermitian as an operator.  The
    kernel walks the rows in their order and reads each slot's x_lo from
    the rows (``ho.bo``); the host tables of distinct x_lo (``ho.ux``,
    ``ho.ix``) are the plain version's."""
    if psi.device.type == "cpu":
        return st.expect_hoisted_ref(psi, ho)
    bo = ho.bo
    N = _buckets(psi, bo, (bo.coef, bo.coef_im))
    _aligned(psi)
    lib = _load("streaming")
    partials = torch.empty(N >> bo.chunk_bits, dtype=torch.float64,
                           device=psi.device)
    out = torch.empty(1, dtype=torch.float32, device=psi.device)
    _launch("expect_hoisted", lib.ovqe_expect_hoisted, psi, N,
            bo.chunk_bits, bo.x_hi, bo.x_lo, bo.k_live, bo.z, bo.coef,
            bo.coef_im, bo.B, bo.gcap, bo.K, int(bo.real), partials, out,
            _stream(psi))
    return out[0]


# ------------------------- per-group streaming route (OVQE_STREAM_FUSE=0)

def _group_ops(psi: torch.Tensor, go: st.GroupOperands,
               coefs: tuple) -> int:
    """Check a per-group operand set against the state; return N."""
    N = _state("psi", psi)
    if N != 1 << go.n:
        raise ValueError(f"state of 2^{N.bit_length() - 1} amplitudes for "
                         f"groups built for n = {go.n}")
    G, Kc = go.G, go.K
    _check("x", go.x, torch.int32, (G,), psi.device)
    _check("z", go.z, torch.int32, (G, Kc), psi.device)
    _check("z_pair", go.z_pair, torch.int32, (G, Kc), psi.device)
    _check("k_live", go.k_live, torch.int32, (G,), psi.device)
    for i, c in enumerate(coefs):
        _check(f"coef{i}", c, torch.float32, (G, Kc), psi.device)
    return N


def rot_stream(psi, ang, go: st.GroupOperands, fmode: int,
               inplace: bool = False):
    """The rotation sweep over the groups of ``go`` in order; ang (G,)
    holds -theta[op] per group.  ``inplace`` rotates psi itself and
    returns it (no second state).  ``go`` must carry the odd-Y
    certificate (``go.odd_y``) on either device.  On the card the G
    launches (one per group, ``stream_per(N)`` pairs a thread) are one
    CUDA graph, captured on the first call for ``go`` (and this N, PER,
    field mode and stream) and replayed after, as ``adjoint_stream``'s;
    one host thread at a time may call it on one ``go``."""
    _odd_y(go)
    if psi.device.type == "cpu":
        return _in_place(psi, st.rot_stream_ref(psi, ang, go, fmode),
                         inplace)
    N = _group_ops(psi, go, (go.coef,))
    _check("ang", ang, torch.float32, (go.G,), psi.device)
    fmode = _fmode(fmode)
    out = psi if inplace else torch.empty_like(psi).copy_(psi)
    if go.G:
        _rot_stream(out, ang, go, fmode, stream_per(N))
    return out


def _rot_stream(psi, ang, go: st.GroupOperands, fmode: int, per: int):
    """A2 on psi in place at ``per`` pairs a thread (``stream_per``'s on
    the entry point's path): one replay of the operand set's graph."""
    N = psi.shape[-1]
    _load("stream_group")       # builds and reads _sg_threads
    nb = -(-(N // 2 // per) // _sg_threads)
    stream = _stream(psi)
    _stream_graph("rot_stream", go, N, per, fmode, nb, stream).replay(
        "rot_stream", (psi.data_ptr(), 0, ang.data_ptr(), 0, 0), stream)


STREAM_PER = 8          # pairs per thread of A2 and C8


def stream_per(N: int) -> int:
    """A2's and C8's pairs per thread on a state of N amplitudes:
    ``STREAM_PER``, or the largest power of two below it whose 256-thread
    blocks the state's N / 2 pairs fill (1 below 2^9 amplitudes, with idle
    threads).  A state size the kernel does not take (not a power of two
    from 2 to 2^30) raises ``ValueError``."""
    if N < 2 or N > 1 << 30 or N & (N - 1):
        raise ValueError(f"no A2 or C8 launch for a state of {N} "
                         f"amplitudes")
    per = STREAM_PER
    while per > 1 and per * 256 > N // 2:
        per //= 2
    return per


class _Graph:
    """An executable CUDA graph of one operand set's launches, captured by
    the C entry point ``capture`` of library ``lib``, and the device buffer
    its kernels read each call's five pointers from (``AdjointArgs`` in
    ``csrc/stream_group_kernels.cu``, ``SweepArgs`` in
    ``csrc/grouped_kernels.cu``).  Each library frees it with
    ``ovqe_graph_destroy``."""

    def __init__(self, lib: str, capture: str, device, *args):
        self.lib, self.device = lib, device
        with torch.cuda.device(device):
            self.args = torch.empty(5, dtype=torch.int64, device=device)
            exec_ = ctypes.c_void_p()
            rc = getattr(_load(lib), capture)(
                *args, self.args.data_ptr(), ctypes.addressof(exec_))
        if rc != 0:
            raise RuntimeError(f"{capture}: CUDA error {rc} while capturing "
                               f"a graph")
        self.exec = exec_.value

    def replay(self, name: str, ptrs: tuple, stream: int) -> None:
        """Fill the five pointers in stream order, launch the graph on
        ``stream`` and count the launch under ``name``."""
        host = (ctypes.c_void_p * 5)(*ptrs)
        with torch.cuda.device(self.device):
            _launch(name, _load(self.lib).ovqe_graph_replay, self.exec,
                    self.args, ctypes.addressof(host), stream)

    def __del__(self):
        lib = _libs.get(getattr(self, "lib", None))
        if lib is not None and getattr(self, "exec", None):
            lib.ovqe_graph_destroy(self.exec)


def _stream_graph(name: str, go: st.GroupOperands, N: int, per: int,
                  fmode: int, nb: int, stream: int) -> _Graph:
    """The graph of A2 (``rot_stream``) or C8 (``adjoint_stream``) on
    ``go`` for this state size, PER, field mode and stream, captured on
    first use and kept in ``go.graphs``.  Its kernels hold go's device
    pointers, which key it too.  Each stream has a graph and an argument
    buffer of its own: a replay fills the buffer and launches the graph in
    that stream's order, so calls on two streams cannot overwrite what the
    other's replay still reads."""
    key = (name, N, per, fmode, stream, go.x.data_ptr(),
           go.z_pair.data_ptr(), go.coef.data_ptr(), go.k_live.data_ptr())
    if key not in go.graphs:
        go.graphs[key] = _Graph(
            "stream_group", f"ovqe_{name}_graph", go.x.device, N,
            go.x.data_ptr(), go.z_pair.data_ptr(), go.coef.data_ptr(),
            go.k_live.data_ptr(), go.G, go.K, fmode, per, nb)
    return go.graphs[key]


def adjoint_stream(p, lam, ang, go: st.GroupOperands, fmode: int):
    """Reversible adjoint over the groups of ``go`` in its order, which is
    the REVERSED sequence (one launch per group); returns (p_prev,
    lam_prev, gts) with gts (G,) in go's order: gts[i] is the entry of
    go's group i, to be summed into theta with go.op (the JAX package's
    ``adjoint_sweep_stream`` returns its entries in the same order).
    ``go`` must carry the odd-Y certificate (``go.odd_y``) on either
    device.  On the card the G + 1 launches are one CUDA graph, captured
    on the first call for ``go`` (and this N, PER, field mode and stream)
    and replayed after; its kernels read the call's states, angles and
    outputs from a device buffer the replay fills, in stream order.  One
    host thread at a time may call it on one ``go``: two threads on one
    stream could interleave their buffer writes and replays."""
    _odd_y(go)
    if p.device.type == "cpu":
        return st.adjoint_stream_ref(p, lam, ang, go, fmode)
    N = _group_ops(p, go, (go.coef,))
    _check("lam", lam, torch.float32, (2, N), p.device)
    _check("ang", ang, torch.float32, (go.G,), p.device)
    _load("stream_group")       # builds and reads _sg_threads
    p_out, l_out = torch.empty_like(p), torch.empty_like(lam)
    p_out.copy_(p)
    l_out.copy_(lam)
    gts = torch.empty(go.G, dtype=torch.float32, device=p.device)
    if go.G:
        per = stream_per(N)
        nb = -(-(N // 2 // per) // _sg_threads)
        partials = torch.empty((go.G, nb), dtype=torch.float64,
                               device=p.device)
        stream = _stream(p)
        _stream_graph("adjoint_stream", go, N, per, _fmode(fmode), nb,
                      stream).replay(
            "adjoint_stream", (p_out.data_ptr(), l_out.data_ptr(),
                               ang.data_ptr(), partials.data_ptr(),
                               gts.data_ptr()), stream)
    return p_out, l_out, gts


def stream_group_attributes(name: str, go: st.GroupOperands
                            ) -> Dict[str, int]:
    """How ``rot_stream`` or ``adjoint_stream`` launches on ``go`` at a
    2^n state: resident blocks per SM, registers and local (spill) bytes
    per thread, static shared memory per block, threads per block, the
    compiled term tile and the pairs per thread."""
    if name not in ("rot_stream", "adjoint_stream"):
        raise ValueError(f"not a per-group streaming sweep: {name}")
    out = (ctypes.c_int * 7)()
    rc = _load("stream_group").ovqe_stream_group_attrs(
        int(name == "adjoint_stream"), stream_per(1 << go.n), go.K,
        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"stream_group_attributes({name}): CUDA error "
                           f"{rc}")
    keys = ("blocks_per_sm", "registers", "spill_bytes", "smem_bytes",
            "threads", "k_tile", "per")
    return dict(zip(keys, list(out)))


HAM_STREAM_PER = 8      # amplitudes a thread of B5 (ham_stream): the
                        # fastest of 1, 2, 4, 8 at H10 on an H100
HAM_STREAM_THREADS = 512        # SG_HAM_THREADS of stream_group_kernels.cu


def ham_stream_per(N: int) -> int:
    """B5's amplitudes per thread on a state of N amplitudes:
    ``HAM_STREAM_PER``, or the largest power of two below it whose blocks
    of ``HAM_STREAM_THREADS`` the state fills (1, with idle threads, below
    ``HAM_STREAM_THREADS``)."""
    per = HAM_STREAM_PER
    while per > 1 and per * HAM_STREAM_THREADS > N:
        per //= 2
    return per


def _ham_stream(psi, acc, go: st.GroupOperands, per: int):
    """B5's launch at ``per`` amplitudes a thread (``ham_stream_per``'s on
    the wrapper's path)."""
    N = _group_ops(psi, go, (go.coef, go.coef_im))
    if acc is not None:
        _check("acc", acc, torch.float32, (2, N), psi.device)
    lib = _load("stream_group")
    out = torch.empty_like(psi)
    _launch("ham_stream", lib.ovqe_ham_stream, psi, acc, out, N, go.x, go.z,
            go.coef, go.coef_im, go.k_live, go.G, go.K, int(go.real), per,
            _stream(psi))
    return out


def ham_stream(psi, acc, go: st.GroupOperands):
    """acc + sum_g W_g psi[j ^ x_g] over every group of ``go`` (acc None
    counts as zero).  On the card one launch, ``ham_stream_per(N)``
    amplitudes a thread, a float64 sum per amplitude; each group adds its
    ``go.k_live`` terms, and W_im only where ``go.real`` is false (its +0
    product is kept from a given acc, where it can set a zero's sign)."""
    if psi.device.type == "cpu":
        return st.ham_stream_ref(psi, acc, go)
    return _ham_stream(psi, acc, go, ham_stream_per(_state("psi", psi)))


def ham_stream_attributes(go: st.GroupOperands, n: int,
                          acc: bool = False) -> Dict[str, int]:
    """How ``ham_stream`` launches on ``go`` at a 2^n state with acc None,
    or given (``acc``: the other instance where ``go.real``); the keys of
    ``ham_attributes``."""
    fn = _load("stream_group").ovqe_ham_stream_attrs
    return _walk_attrs("ham_stream_attributes",
                       lambda per, K, real, out: fn(per, K, real, int(acc),
                                                    out),
                       ham_stream_per(1 << n), go)


EXPECT_STREAM_PER = 8   # amplitudes a thread of D11 (expect_stream): the
                        # fastest of 1, 2, 4, 8 at H10 on an H100
EXPECT_STREAM_THREADS = 256     # SG_EXP_THREADS of stream_group_kernels.cu


def expect_stream_per(N: int) -> int:
    """D11's amplitudes per thread on a state of N amplitudes:
    ``EXPECT_STREAM_PER``, or the largest power of two below it whose
    blocks of ``EXPECT_STREAM_THREADS`` the state fills (1, with idle
    threads, below ``EXPECT_STREAM_THREADS``)."""
    per = EXPECT_STREAM_PER
    while per > 1 and per * EXPECT_STREAM_THREADS > N:
        per //= 2
    return per


def _expect_stream(psi, go: st.GroupOperands, herm: bool, per: int):
    """D11's launch at ``per`` amplitudes a thread (``expect_stream_per``'s
    on the wrapper's path)."""
    N = _group_ops(psi, go, (go.coef, go.coef_im))
    lib = _load("stream_group")
    nb = -(-N // _sg_threads)
    partials = torch.empty(nb, dtype=torch.float64, device=psi.device)
    out = torch.empty(1, dtype=torch.float32, device=psi.device)
    _launch("expect_stream", lib.ovqe_expect_stream, psi, N, go.x, go.z,
            go.coef, go.coef_im, go.k_live, go.G, go.K, int(go.real),
            int(bool(herm)), per, partials, nb, out, _stream(psi))
    return out[0]


def expect_stream(psi, go: st.GroupOperands, herm: bool = False):
    """The groups of ``go`` contracted with conj(psi), a 0-dim tensor;
    ``herm`` only where the caller certifies every group Hermitian as an
    operator (``streaming.grouped_hermitian_operator``).  On the card one
    launch and its fixed-order sum, ``expect_stream_per(N)`` amplitudes a
    thread; each group adds its ``go.k_live`` terms, and W_im only where
    ``go.real`` is false."""
    if psi.device.type == "cpu":
        return st.expect_stream_ref(psi, go, herm)
    N = _group_ops(psi, go, (go.coef, go.coef_im))
    if not go.G:
        return torch.zeros((), dtype=psi.dtype, device=psi.device)
    return _expect_stream(psi, go, herm, expect_stream_per(N))


def expect_stream_attributes(go: st.GroupOperands, n: int) -> Dict[str, int]:
    """How ``expect_stream`` launches on ``go`` at a 2^n state (the keys of
    ``ham_attributes``)."""
    return _walk_attrs("expect_stream_attributes",
                       _load("stream_group").ovqe_expect_stream_attrs,
                       expect_stream_per(1 << n), go)


# ----------------------------------------------------------- pool screen

POOL_MAX_GCAP = 16      # PB_MAX_GCAP of csrc/pool_kernels.cu


def _pool_ops(sigma, psi, po: convert.PoolOperands) -> int:
    """Check E14's operands against the states; return N."""
    N = _state("psi", psi)
    _check("sigma", sigma, torch.float32, (2, N), psi.device)
    _groups(psi, po.x, po.z, (po.a_re, po.a_im))
    _check("k_live", po.k_live, torch.int32, (po.G,), psi.device)
    return N


def pool_overlap(sigma, psi, po: convert.PoolOperands):
    """(G, 2) rows (re, im) of <sigma| W_g X^{x_g} |psi> over the groups of
    ``po`` (``convert.pool_operands``), every group in one launch; each
    group adds its ``po.k_live`` terms, and W_im only where ``po.real`` is
    false."""
    if psi.device.type == "cpu":
        return st.pool_overlap_ref(sigma, psi, *po.args())
    N = _pool_ops(sigma, psi, po)
    lib = _load("pool")
    out = torch.empty((po.G, 2), dtype=torch.float32, device=psi.device)
    if po.G:
        nb = lib.ovqe_pool_blocks(N)
        partials = torch.empty((2 * po.G, nb), dtype=torch.float64,
                               device=psi.device)
        _launch("pool_overlap", lib.ovqe_pool_overlap, sigma, psi, N, po.x,
                po.z, po.a_re, po.a_im, po.k_live, po.G, po.K, int(po.real),
                partials, nb, out, _stream(psi))
    return out


def pool_bucketed(sigma, psi, bo: st.BucketOperands):
    """(B, gcap, 2) rows (re, im) of the pool groups in ``bo``, one launch
    over all buckets; each slot adds its ``bo.k_live`` terms (zeros in
    padding slots), and W_im only where ``bo.real`` is false."""
    if psi.device.type == "cpu":
        return st.pool_bucketed_ref(sigma, psi, bo)
    N = _buckets(psi, bo, (bo.coef, bo.coef_im))
    _check("sigma", sigma, torch.float32, (2, N), psi.device)
    if bo.gcap > POOL_MAX_GCAP:
        raise ValueError(f"pool buckets hold at most {POOL_MAX_GCAP} slots, "
                         f"got {bo.gcap}")
    lib = _load("pool")
    partials = torch.empty((bo.B * bo.gcap * 2, N >> bo.chunk_bits),
                           dtype=torch.float64, device=psi.device)
    out = torch.empty((bo.B, bo.gcap, 2), dtype=torch.float32,
                      device=psi.device)
    _launch("pool_bucketed", lib.ovqe_pool_bucketed, sigma, psi, N,
            bo.chunk_bits, bo.x_hi, bo.x_lo, bo.k_live, bo.z, bo.coef,
            bo.coef_im, bo.B, bo.gcap, bo.K, int(bo.real), partials, out,
            _stream(psi))
    return out


def pool_attributes(name: str, ops, n: int) -> Dict[str, int]:
    """How ``pool_overlap`` (``ops`` a ``convert.PoolOperands``) or
    ``pool_bucketed`` (``ops`` a ``streaming.BucketOperands``) launches on
    a 2^n state: registers and local (spill) bytes per thread, dynamic
    shared memory and threads per block, resident blocks per SM, the
    compiled term tile, the amplitudes per thread and (E14) the groups a
    block walks (the instance is chosen by K, realness and, for E15, the
    chunk)."""
    if name not in ("pool_overlap", "pool_bucketed"):
        raise ValueError(f"not a pool kernel: {name}")
    bucketed = name == "pool_bucketed"
    out = (ctypes.c_int * 8)()
    rc = _load("pool").ovqe_pool_attrs(
        int(bucketed), ops.K, int(ops.real), n,
        ops.chunk_bits if bucketed else 0, 1 if bucketed else max(1, ops.G),
        ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"pool_attributes({name}): CUDA error {rc}")
    keys = ("registers", "local_bytes", "smem_bytes", "threads",
            "blocks_per_sm", "k_tile", "per", "run")
    return dict(zip(keys, list(out)))
