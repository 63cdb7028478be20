"""ctypes bindings for the native GAM codec (vgan_tpu/cpp/gamcodec.cpp).

Decodes a whole GAM into columnar numpy arrays in C++ (BGZF inflate +
protobuf walk), the native-runtime analogue of the reference's
libvgio ingestion (`src/readGAM.h:37-51`). Falls back transparently to
the pure-python codec when the shared library is absent; `build()`
compiles it with the in-tree Makefile.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_CPP_DIR = os.path.join(os.path.dirname(__file__), "..", "cpp")
_LIB_PATH = os.path.join(_CPP_DIR, "libgamcodec.so")
_lib = None


def build() -> bool:
    """Compile the native library from vgan_tpu/cpp at first use.

    Processes that start together (e.g. test workers) serialize on a
    lock file; each build writes a private temporary name that is
    renamed into place, so no process ever loads a half-written
    library. Returns True when the library exists afterwards."""
    import fcntl

    if os.path.exists(_LIB_PATH):
        return True
    with open(os.path.join(_CPP_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_LIB_PATH):
            return True
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["make", "-C", _CPP_DIR, f"OUT={tmp}"],
                check=True, capture_output=True,
            )
            os.replace(tmp, _LIB_PATH)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return False
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.gam_parse.restype = ctypes.c_void_p
    lib.gam_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.gam_free.argtypes = [ctypes.c_void_p]
    for name in ["gam_n_reads", "gam_n_mappings", "gam_n_edits",
                 "gam_seqs_len", "gam_names_len", "gam_quals_len",
                 "gam_eseqs_len"]:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    ptrs = {
        # char buffers come back as raw addresses (c_void_p), NOT
        # c_char_p: ctypes converts a c_char_p return value to a bytes
        # object truncated at the first NUL — quality strings contain
        # phred-0 bytes, so string_at on the truncated copy read heap
        # garbage past it.
        "gam_seqs": ctypes.c_void_p, "gam_names": ctypes.c_void_p,
        "gam_quals": ctypes.c_void_p, "gam_eseqs": ctypes.c_void_p,
        "gam_seq_off": ctypes.POINTER(ctypes.c_int64),
        "gam_name_off": ctypes.POINTER(ctypes.c_int64),
        "gam_qual_off": ctypes.POINTER(ctypes.c_int64),
        "gam_eseq_off": ctypes.POINTER(ctypes.c_int64),
        "gam_mapq": ctypes.POINTER(ctypes.c_int32),
        "gam_score": ctypes.POINTER(ctypes.c_int32),
        "gam_identity": ctypes.POINTER(ctypes.c_double),
        "gam_paired": ctypes.POINTER(ctypes.c_uint8),
        "gam_map_start": ctypes.POINTER(ctypes.c_int64),
        "gam_node_id": ctypes.POINTER(ctypes.c_int64),
        "gam_node_off": ctypes.POINTER(ctypes.c_int32),
        "gam_is_rev": ctypes.POINTER(ctypes.c_uint8),
        "gam_rank": ctypes.POINTER(ctypes.c_int32),
        "gam_edit_start": ctypes.POINTER(ctypes.c_int64),
        "gam_from_len": ctypes.POINTER(ctypes.c_int32),
        "gam_to_len": ctypes.POINTER(ctypes.c_int32),
    }
    for name, restype in ptrs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


@dataclass
class GamColumns:
    """Columnar GAM decode (zero-copy views are materialized into numpy
    before the native handle is freed)."""

    n_reads: int
    seqs: bytes
    seq_off: np.ndarray
    names: bytes
    name_off: np.ndarray
    quals: bytes
    qual_off: np.ndarray
    mapq: np.ndarray
    score: np.ndarray
    identity: np.ndarray
    paired: np.ndarray
    map_start: np.ndarray  # [n_reads+1] CSR into mappings
    node_id: np.ndarray
    node_off: np.ndarray
    is_rev: np.ndarray
    rank: np.ndarray
    edit_start: np.ndarray  # [n_mappings+1] CSR into edits
    from_len: np.ndarray
    to_len: np.ndarray
    eseqs: bytes
    eseq_off: np.ndarray

    def read_seq(self, i: int) -> str:
        return self.seqs[self.seq_off[i] : self.seq_off[i + 1]].decode()

    def read_name(self, i: int) -> str:
        return self.names[self.name_off[i] : self.name_off[i + 1]].decode()

    def read_qual(self, i: int) -> bytes:
        return self.quals[self.qual_off[i] : self.qual_off[i + 1]]


def read_gam_columns(path: str) -> Optional[GamColumns]:
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    h = lib.gam_parse(data, len(data))
    if not h:
        return None
    try:
        n = lib.gam_n_reads(h)
        nm = lib.gam_n_mappings(h)
        ne = lib.gam_n_edits(h)

        def arr(fn, count, dtype):
            ptr = fn(h)
            if count == 0:
                return np.zeros(0, dtype=dtype)
            return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)

        def raw(fn, length):
            return ctypes.string_at(fn(h), length)

        return GamColumns(
            n_reads=n,
            seqs=raw(lib.gam_seqs, lib.gam_seqs_len(h)),
            seq_off=arr(lib.gam_seq_off, n + 1, np.int64),
            names=raw(lib.gam_names, lib.gam_names_len(h)),
            name_off=arr(lib.gam_name_off, n + 1, np.int64),
            quals=raw(lib.gam_quals, lib.gam_quals_len(h)),
            qual_off=arr(lib.gam_qual_off, n + 1, np.int64),
            mapq=arr(lib.gam_mapq, n, np.int32),
            score=arr(lib.gam_score, n, np.int32),
            identity=arr(lib.gam_identity, n, np.float64),
            paired=arr(lib.gam_paired, n, np.uint8),
            map_start=arr(lib.gam_map_start, n + 1, np.int64),
            node_id=arr(lib.gam_node_id, nm, np.int64),
            node_off=arr(lib.gam_node_off, nm, np.int32),
            is_rev=arr(lib.gam_is_rev, nm, np.uint8),
            rank=arr(lib.gam_rank, nm, np.int32),
            edit_start=arr(lib.gam_edit_start, nm + 1, np.int64),
            from_len=arr(lib.gam_from_len, ne, np.int32),
            to_len=arr(lib.gam_to_len, ne, np.int32),
            eseqs=raw(lib.gam_eseqs, lib.gam_eseqs_len(h)),
            eseq_off=arr(lib.gam_eseq_off, ne + 1, np.int64),
        )
    finally:
        lib.gam_free(h)


def read_gam_native(path: str):
    """Read a GAM via the native codec, returning the same Alignment
    objects as io.gam's pure-Python decode. Returns None when the
    native lib is unavailable (caller falls back)."""
    from . import gam as pygam

    cols = read_gam_columns(path)
    if cols is None:
        return None
    out: List[pygam.Alignment] = []
    for i in range(cols.n_reads):
        a = pygam.Alignment(
            sequence=cols.read_seq(i),
            name=cols.read_name(i),
            quality=cols.read_qual(i),
            mapping_quality=int(cols.mapq[i]),
            score=int(cols.score[i]),
            identity=float(cols.identity[i]),
            read_paired=bool(cols.paired[i]),
        )
        for m in range(cols.map_start[i], cols.map_start[i + 1]):
            mp = pygam.Mapping(
                position=pygam.Position(
                    node_id=int(cols.node_id[m]),
                    offset=int(cols.node_off[m]),
                    is_reverse=bool(cols.is_rev[m]),
                ),
                rank=int(cols.rank[m]),
            )
            for e in range(cols.edit_start[m], cols.edit_start[m + 1]):
                mp.edits.append(
                    pygam.Edit(
                        from_length=int(cols.from_len[e]),
                        to_length=int(cols.to_len[e]),
                        sequence=cols.eseqs[
                            cols.eseq_off[e] : cols.eseq_off[e + 1]
                        ].decode(),
                    )
                )
            a.path.mappings.append(mp)
        out.append(a)
    return out


def read_gam_fast(path: str):
    """Native-codec GAM read with pure-Python fallback (legacy name;
    io.gam.read_gam now routes here by default)."""
    out = read_gam_native(path)
    if out is not None:
        return out
    from . import gam as pygam

    return pygam.read_gam(path, native=False)
