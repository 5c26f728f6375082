"""The hand-written CUDA kernels of the port and their wrappers: the
counterpart of ``openvqe_tpu/sim/pallas_kernels.py`` (per-group route,
n <= 19), of ``openvqe_tpu/sim/streaming.py``'s default path (bucketed
route, n >= 20) and its per-group path (OVQE_STREAM_FUSE=0), and of its
two ADAPT pool-screen kernels.

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
are those of ``sim/convert.py``: x (G,) int32, z (G, K) int32,
coefficients (G, K) float32, angles (G,) float32; bucketed operands are a
``streaming.BucketOperands`` with angles (B, gcap) float32; per-group
streaming operands a ``streaming.GroupOperands`` with angles (G,)
float32; pool-overlap rows are (G, 2) or (B, gcap, 2) float32 (re, im);
state planes are (2, 2^n) float32, all contiguous and on one device.
Outputs are allocated with ``torch.empty`` and the kernels run on the
current stream.  ``LAUNCHES`` counts, per wrapper, the calls that launched
the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

from . import grouped as gr
from . import streaming as st

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"grouped": CSRC / "grouped_kernels.cu",
           "streaming": CSRC / "streaming_kernels.cu",
           "stream_group": CSRC / "stream_group_kernels.cu",
           "pool": CSRC / "pool_kernels.cu"}
HEADERS = (CSRC / "common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

KERNELS = ("rot_sweep", "expectation", "ham_apply", "adjoint_sweep",
           "rot_fused", "adjoint_fused", "ham_bucketed", "expect_bucketed",
           "rot_stream", "adjoint_stream", "ham_stream", "expect_stream",
           "pool_overlap", "pool_bucketed")
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
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for hdr in HEADERS:
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
        "ovqe_rot_sweep": "PLPPPPIIIP",
        "ovqe_adjoint_sweep": "PPLPPPPIIIPIPP",
        "ovqe_ham_apply": "PPLPPPPIIP",
        "ovqe_expectation": "PLPPPPIIPIPP",
        "ovqe_block_threads": "",
    },
    "streaming": {
        "ovqe_rot_fused": "PLIPPPPPPIIIIP",
        "ovqe_adjoint_fused": "PPLIPPPPPPIIIIPPP",
        "ovqe_ham_bucketed": "PPPLIPPPPPPIIIIP",
        "ovqe_expect_bucketed": "PLIPPPPPPIIIIPPP",
    },
    "stream_group": {
        "ovqe_rot_stream": "PLPPPPPIIIP",
        "ovqe_adjoint_stream": "PPLPPPPPIIIPIPP",
        "ovqe_ham_stream": "PPPLPPPPPIIP",
        "ovqe_expect_stream": "PLPPPPPIIIPIPP",
        "ovqe_sg_block_threads": "",
    },
    "pool": {
        "ovqe_pool_overlap": "PPLPPPPIIPIPP",
        "ovqe_pool_bucketed": "PPLIPPPPPPIIIIPPP",
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


def rot_sweep(psi, angles, x, z, s, fmode: int):
    """prod_g Rot(B_g) psi, groups in order; B_g(j) = angles[g] F_g(j)."""
    if psi.device.type == "cpu":
        return gr.rot_sweep_ref(psi, angles, x, z, s, fmode)
    N = _state("psi", psi)
    G, K = _groups(psi, x, z, (s,), angles)
    lib = _load()
    out = torch.empty_like(psi)
    out.copy_(psi)
    if G:
        _launch("rot_sweep", lib.ovqe_rot_sweep, out, N, x, z, s, angles,
                G, K, _fmode(fmode), _stream(psi))
    return out


def adjoint_sweep(p, lam, angles, x, z, s, fmode: int):
    """Reversible adjoint over the groups in reverse order; returns
    (p_prev, lam_prev, gts) with gts (G,) the per-group gradient entries in
    forward group order."""
    if p.device.type == "cpu":
        return gr.adjoint_sweep_ref(p, lam, angles, x, z, s, fmode)
    N = _state("p", p)
    _check("lam", lam, torch.float32, (2, N), p.device)
    G, K = _groups(p, x, z, (s,), angles)
    lib = _load()
    p_out, l_out = torch.empty_like(p), torch.empty_like(lam)
    p_out.copy_(p)
    l_out.copy_(lam)
    gts = torch.empty(G, dtype=torch.float32, device=p.device)
    if G:
        nb = -(-(N // 2) // _threads)
        partials = torch.empty((G, nb), dtype=torch.float32, device=p.device)
        _launch("adjoint_sweep", lib.ovqe_adjoint_sweep, p_out, l_out, N,
                x, z, s, angles, G, K, _fmode(fmode), partials, nb, gts,
                _stream(p))
    return p_out, l_out, gts


def ham_apply(psi, x, z, a_re, a_im):
    """sum_g W_g(j) psi[j ^ x_g] (x = 0 groups carry the diagonal; the
    identity offset is the caller's)."""
    if psi.device.type == "cpu":
        return gr.ham_apply_ref(psi, x, z, a_re, a_im)
    N = _state("psi", psi)
    G, K = _groups(psi, x, z, (a_re, a_im))
    lib = _load()
    out = torch.empty_like(psi)
    _launch("ham_apply", lib.ovqe_ham_apply, psi, out, N, x, z, a_re, a_im,
            G, K, _stream(psi))
    return out


def expectation(psi, x, z, a_re, a_im):
    """sum_g sum_j Re(conj(psi_j) W_g(j) psi_{j^x_g}) as a 0-dim tensor."""
    if psi.device.type == "cpu":
        return gr.expectation_ref(psi, x, z, a_re, a_im)
    N = _state("psi", psi)
    G, K = _groups(psi, x, z, (a_re, a_im))
    lib = _load()
    nb = -(-N // _threads)
    partials = torch.empty(nb, dtype=torch.float32, device=psi.device)
    out = torch.empty(1, dtype=torch.float32, device=psi.device)
    _launch("expectation", lib.ovqe_expectation, psi, N, x, z, a_re, a_im,
            G, K, partials, nb, out, _stream(psi))
    return out[0]


# ------------------------------------------------ bucketed (streaming) route

# chunk sizes the streaming kernels are built for (ST_MIN_CB, ST_MAX_CB of
# csrc/streaming_kernels.cu): 2^(cb - 8) amplitudes per thread of 256
CUDA_CHUNK_BITS = (8, 12)


def _buckets(psi: torch.Tensor, bo: st.BucketOperands,
             coefs: tuple) -> int:
    """Check a bucket operand set against the state; return N."""
    N = _state("psi", psi)
    if N != 1 << bo.n:
        raise ValueError(f"state of 2^{N.bit_length() - 1} amplitudes for "
                         f"buckets built for n = {bo.n}")
    lo, hi = CUDA_CHUNK_BITS
    if not lo <= bo.chunk_bits <= min(hi, bo.n - 1):
        raise ValueError(f"the CUDA kernels take chunk_bits in [{lo}, "
                         f"{min(hi, bo.n - 1)}], got {bo.chunk_bits}")
    B, gcap, Kc = bo.B, bo.gcap, bo.K
    if B == 0:
        raise ValueError("empty bucket set")
    _check("x_hi", bo.x_hi, torch.int32, (B,), psi.device)
    _check("x_lo", bo.x_lo, torch.int32, (B, gcap), psi.device)
    _check("act", bo.act, torch.int32, (B, gcap), psi.device)
    _check("z", bo.z, torch.int32, (B, gcap, Kc), psi.device)
    for i, c in enumerate(coefs):
        _check(f"coef{i}", c, torch.float32, (B, gcap, Kc), psi.device)
    return N


def rot_fused(psi, ang, bo: st.BucketOperands, fmode: int):
    """The rotation sweep over the runs of ``bo`` in order (one launch per
    run); ang (B, gcap) holds -theta[op] per slot."""
    if psi.device.type == "cpu":
        return st.rot_fused_ref(psi, ang, bo, fmode)
    N = _buckets(psi, bo, (bo.coef,))
    _check("ang", ang, torch.float32, (bo.B, bo.gcap), psi.device)
    lib = _load("streaming")
    out = torch.empty_like(psi)
    out.copy_(psi)
    _launch("rot_fused", lib.ovqe_rot_fused, out, N, bo.chunk_bits, bo.x_hi,
            bo.x_lo, bo.act, bo.z, bo.coef, ang, bo.B, bo.gcap, bo.K,
            _fmode(fmode), _stream(psi))
    return out


def adjoint_fused(p, lam, ang, bo: st.BucketOperands, fmode: int):
    """Reversible adjoint over the runs of the REVERSED sequence in ``bo``;
    returns (p_prev, lam_prev, gts) with gts (B, gcap) the per-slot
    gradient entries (0 in padding slots)."""
    if p.device.type == "cpu":
        return st.adjoint_fused_ref(p, lam, ang, bo, fmode)
    N = _buckets(p, bo, (bo.coef,))
    _check("lam", lam, torch.float32, (2, N), p.device)
    _check("ang", ang, torch.float32, (bo.B, bo.gcap), p.device)
    lib = _load("streaming")
    p_out, l_out = torch.empty_like(p), torch.empty_like(lam)
    p_out.copy_(p)
    l_out.copy_(lam)
    nblk = N >> (bo.chunk_bits + 1)
    partials = torch.empty((bo.B * bo.gcap, nblk), dtype=torch.float32,
                           device=p.device)
    gts = torch.empty((bo.B, bo.gcap), dtype=torch.float32, device=p.device)
    _launch("adjoint_fused", lib.ovqe_adjoint_fused, p_out, l_out, N,
            bo.chunk_bits, bo.x_hi, bo.x_lo, bo.act, bo.z, bo.coef, ang,
            bo.B, bo.gcap, bo.K, _fmode(fmode), partials, gts, _stream(p))
    return p_out, l_out, gts


def ham_bucketed(psi, acc, bo: st.BucketOperands):
    """acc + (the groups of one K class) |psi> in one launch; acc None
    counts as zero."""
    if psi.device.type == "cpu":
        return st.ham_bucketed_ref(psi, acc, bo)
    N = _buckets(psi, bo, (bo.coef, bo.coef_im))
    if acc is not None:
        _check("acc", acc, torch.float32, (2, N), psi.device)
    lib = _load("streaming")
    out = torch.empty_like(psi)
    _launch("ham_bucketed", lib.ovqe_ham_bucketed, psi, acc, out, N,
            bo.chunk_bits, bo.x_hi, bo.x_lo, bo.act, bo.z, bo.coef,
            bo.coef_im, bo.B, bo.gcap, bo.K, int(bo.real), _stream(psi))
    return out


def expect_bucketed(psi, bo: st.BucketOperands):
    """The groups of one K class contracted with conj(psi): a 0-dim
    tensor."""
    if psi.device.type == "cpu":
        return st.expect_bucketed_ref(psi, bo)
    N = _buckets(psi, bo, (bo.coef, bo.coef_im))
    lib = _load("streaming")
    partials = torch.empty(N >> bo.chunk_bits, dtype=torch.float64,
                           device=psi.device)
    out = torch.empty(1, dtype=torch.float32, device=psi.device)
    _launch("expect_bucketed", lib.ovqe_expect_bucketed, psi, N,
            bo.chunk_bits, bo.x_hi, bo.x_lo, bo.act, bo.z, bo.coef,
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
    _check("k_live", go.k_live, torch.int32, (G,), psi.device)
    for i, c in enumerate(coefs):
        _check(f"coef{i}", c, torch.float32, (G, Kc), psi.device)
    return N


def rot_stream(psi, ang, go: st.GroupOperands, fmode: int):
    """The rotation sweep over the groups of ``go`` in order, one launch
    per group; ang (G,) holds -theta[op] per group."""
    if psi.device.type == "cpu":
        return st.rot_stream_ref(psi, ang, go, fmode)
    N = _group_ops(psi, go, (go.coef,))
    _check("ang", ang, torch.float32, (go.G,), psi.device)
    lib = _load("stream_group")
    out = torch.empty_like(psi)
    out.copy_(psi)
    if go.G:
        _launch("rot_stream", lib.ovqe_rot_stream, out, N, go.x, go.z,
                go.coef, go.k_live, ang, go.G, go.K, _fmode(fmode),
                _stream(psi))
    return out


def adjoint_stream(p, lam, ang, go: st.GroupOperands, fmode: int):
    """Reversible adjoint over the groups of ``go`` in its order, which is
    the REVERSED sequence (one launch per group); returns (p_prev,
    lam_prev, gts) with gts (G,) in go's order: gts[i] is the entry of
    go's group i, to be summed into theta with go.op (the JAX package's
    ``adjoint_sweep_stream`` returns its entries in the same order)."""
    if p.device.type == "cpu":
        return st.adjoint_stream_ref(p, lam, ang, go, fmode)
    N = _group_ops(p, go, (go.coef,))
    _check("lam", lam, torch.float32, (2, N), p.device)
    _check("ang", ang, torch.float32, (go.G,), p.device)
    lib = _load("stream_group")
    p_out, l_out = torch.empty_like(p), torch.empty_like(lam)
    p_out.copy_(p)
    l_out.copy_(lam)
    gts = torch.empty(go.G, dtype=torch.float32, device=p.device)
    if go.G:
        nb = -(-(N // 2) // _sg_threads)
        partials = torch.empty((go.G, nb), dtype=torch.float64,
                               device=p.device)
        _launch("adjoint_stream", lib.ovqe_adjoint_stream, p_out, l_out, N,
                go.x, go.z, go.coef, go.k_live, ang, go.G, go.K,
                _fmode(fmode), partials, nb, gts, _stream(p))
    return p_out, l_out, gts


def ham_stream(psi, acc, go: st.GroupOperands):
    """acc + sum_g W_g psi[j ^ x_g] over every group in one launch, both
    weight fields; acc None counts as zero."""
    if psi.device.type == "cpu":
        return st.ham_stream_ref(psi, acc, go)
    N = _group_ops(psi, go, (go.coef, go.coef_im))
    if acc is not None:
        _check("acc", acc, torch.float32, (2, N), psi.device)
    lib = _load("stream_group")
    out = torch.empty_like(psi)
    _launch("ham_stream", lib.ovqe_ham_stream, psi, acc, out, N, go.x, go.z,
            go.coef, go.coef_im, go.k_live, go.G, go.K, _stream(psi))
    return out


def expect_stream(psi, go: st.GroupOperands, herm: bool = False):
    """The groups of ``go`` contracted with conj(psi), a 0-dim tensor;
    ``herm`` only where the caller certifies every group Hermitian as an
    operator (``streaming.grouped_hermitian_operator``)."""
    if psi.device.type == "cpu":
        return st.expect_stream_ref(psi, go, herm)
    N = _group_ops(psi, go, (go.coef, go.coef_im))
    lib = _load("stream_group")
    nb = -(-N // _sg_threads)
    partials = torch.empty(nb, dtype=torch.float64, device=psi.device)
    out = torch.empty(1, dtype=torch.float32, device=psi.device)
    _launch("expect_stream", lib.ovqe_expect_stream, psi, N, go.x, go.z,
            go.coef, go.coef_im, go.k_live, go.G, go.K, int(bool(herm)),
            partials, nb, out, _stream(psi))
    return out[0]


# ----------------------------------------------------------- pool screen

POOL_MAX_GCAP = 16      # PB_MAX_GCAP of csrc/pool_kernels.cu


def pool_overlap(sigma, psi, x, z, cre, cim):
    """(G, 2) rows (re, im) of <sigma| W_g X^{x_g} |psi>, every group in
    one launch; x (G,), z (G, K) int32, cre, cim (G, K)."""
    if psi.device.type == "cpu":
        return st.pool_overlap_ref(sigma, psi, x, z, cre, cim)
    N = _state("psi", psi)
    _check("sigma", sigma, torch.float32, (2, N), psi.device)
    G, K = _groups(psi, x, z, (cre, cim))
    lib = _load("pool")
    out = torch.empty((G, 2), dtype=torch.float32, device=psi.device)
    if G:
        nb = lib.ovqe_pool_blocks(N)
        partials = torch.empty((2 * G, nb), dtype=torch.float64,
                               device=psi.device)
        _launch("pool_overlap", lib.ovqe_pool_overlap, sigma, psi, N, x, z,
                cre, cim, G, K, partials, nb, out, _stream(psi))
    return out


def pool_bucketed(sigma, psi, bo: st.BucketOperands):
    """(B, gcap, 2) rows (re, im) of the pool groups in ``bo``, one launch
    over all buckets; zeros in padding slots."""
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
            bo.chunk_bits, bo.x_hi, bo.x_lo, bo.act, bo.z, bo.coef,
            bo.coef_im, bo.B, bo.gcap, bo.K, int(bo.real), partials, out,
            _stream(psi))
    return out
