"""Binary token storage in the Megatron ``.idx``/``.bin`` format (copy of
bdm_db1_tpu/data/indexed_dataset.py; the files are byte-equal both ways).

Two on-disk formats: magic ``MMIDIDX`` (mmap, the production path) and
``TNTIDX`` (legacy, seek reads). Readers:

* ``MMapIndexedDataset`` — np.memmap with zero-copy partial reads
  ``get(idx, offset, length)``;
* ``IndexedDataset`` — lazy file-seek reads of the legacy format;
* ``IndexedCachedDataset`` — the legacy reader with chosen documents
  prefetched into RAM.

Builders append documents and write the index; ``merge_file_`` appends a
finished shard. ``make_builder`` stores uint16 when the vocab is below
65500, else int32.
"""

from __future__ import annotations

import os
import shutil
import struct
from typing import List, Optional, Sequence

import numpy as np

_MMAP_MAGIC = b"MMIDIDX\x00\x00"
_LEGACY_MAGIC = b"TNTIDX\x00\x00"

_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
    5: np.int64, 6: np.float32, 7: np.float64, 8: np.uint16,
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


def dtype_code(dtype) -> int:
    return _DTYPE_CODES[np.dtype(dtype).type]


def best_dtype(vocab_size: Optional[int]):
    if vocab_size is not None and vocab_size < 65500:
        return np.uint16
    return np.int32


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---- mmap format -----------------------------------------------------------

class _MMapIndex:
    """Header (magic, <Q version 1, <B dtype code, <Q len, <Q doc count),
    then int32 sizes, int64 byte pointers and int64 doc_idx."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            _check(f.read(9) == _MMAP_MAGIC, f"bad index magic in {path}")
            (version,) = struct.unpack("<Q", f.read(8))
            _check(version == 1, f"{path}: index version {version}")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(_DTYPES[code])
            (self._len,) = struct.unpack("<Q", f.read(8))
            (self._doc_count,) = struct.unpack("<Q", f.read(8))
            offset = f.tell()
        self._buffer = np.memmap(path, mode="r")
        self.sizes = np.frombuffer(
            self._buffer, dtype=np.int32, count=self._len, offset=offset)
        ptr_off = offset + self.sizes.nbytes
        self.pointers = np.frombuffer(
            self._buffer, dtype=np.int64, count=self._len, offset=ptr_off)
        self.doc_idx = np.frombuffer(
            self._buffer, dtype=np.int64, count=self._doc_count,
            offset=ptr_off + self.pointers.nbytes)

    def __len__(self):
        return self._len

    @staticmethod
    def write(path: str, sizes: Sequence[int], doc_idx: Sequence[int], dtype):
        sizes = np.asarray(sizes, dtype=np.int32)
        itemsize = np.dtype(dtype).itemsize
        pointers = np.zeros(len(sizes), dtype=np.int64)
        np.cumsum(sizes[:-1] * itemsize, out=pointers[1:])
        with open(path, "wb") as f:
            f.write(_MMAP_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", dtype_code(dtype)))
            f.write(struct.pack("<Q", len(sizes)))
            f.write(struct.pack("<Q", len(doc_idx)))
            f.write(sizes.tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))
            f.write(np.asarray(doc_idx, dtype=np.int64).tobytes(order="C"))


class MMapIndexedDataset:
    def __init__(self, prefix: str):
        self._prefix = prefix
        self._index = _MMapIndex(index_file_path(prefix))
        self._bin = np.memmap(data_file_path(prefix), mode="r",
                              dtype=self._index.dtype)

    def __len__(self) -> int:
        return len(self._index)

    @property
    def sizes(self) -> np.ndarray:
        return self._index.sizes

    @property
    def doc_idx(self) -> np.ndarray:
        return self._index.doc_idx

    @property
    def dtype(self):
        return self._index.dtype

    def __getitem__(self, idx: int) -> np.ndarray:
        ptr = self._index.pointers[idx] // self._index.dtype.itemsize
        size = self._index.sizes[idx]
        return np.asarray(self._bin[ptr: ptr + size])

    def get(self, idx: int, offset: int = 0,
            length: Optional[int] = None) -> np.ndarray:
        """Tokens ``offset : offset + length`` of item ``idx`` (to its end
        without a length)."""
        size = int(self._index.sizes[idx])
        length = length if length is not None else size - offset
        ptr = self._index.pointers[idx] // self._index.dtype.itemsize + offset
        return np.asarray(self._bin[ptr: ptr + length])

    @staticmethod
    def exists(prefix: str) -> bool:
        return (os.path.exists(index_file_path(prefix))
                and os.path.exists(data_file_path(prefix)))


class MMapIndexedDatasetBuilder:
    def __init__(self, out_prefix: str, dtype=np.int32):
        self._prefix = out_prefix
        self._dtype = np.dtype(dtype)
        self._data = open(data_file_path(out_prefix), "wb")
        self._sizes: List[int] = []
        self._doc_idx: List[int] = [0]

    def add_item(self, tokens: np.ndarray) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        self._data.write(arr.tobytes(order="C"))
        self._sizes.append(len(arr))

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def add_document(self, tokens: np.ndarray) -> None:
        self.add_item(tokens)
        self.end_document()

    def merge_file_(self, other_prefix: str) -> None:
        index = _MMapIndex(index_file_path(other_prefix))
        doc_offset = len(self._sizes)
        self._sizes.extend(index.sizes.tolist())
        self._doc_idx.extend((index.doc_idx[1:] + doc_offset).tolist())
        with open(data_file_path(other_prefix), "rb") as f:
            shutil.copyfileobj(f, self._data)

    def finalize(self) -> None:
        self._data.close()
        _MMapIndex.write(index_file_path(self._prefix), self._sizes,
                         self._doc_idx, self._dtype)


# ---- legacy format and its RAM cache ----------------------------------------

class IndexedDataset:
    """Lazy file-seek reader of the TNTIDX legacy format: magic, <Q version
    1, <QQ dtype code / element size, <QQ item count / size count, <Q doc
    count, then int64 dim_offsets, data_offsets, sizes and doc_idx."""

    def __init__(self, prefix: str):
        self._prefix = prefix
        path = index_file_path(prefix)
        with open(path, "rb") as f:
            _check(f.read(8) == _LEGACY_MAGIC, f"bad legacy index magic in "
                                               f"{path}")
            (version,) = struct.unpack("<Q", f.read(8))
            _check(version == 1, f"{path}: index version {version}")
            code, self._element_size = struct.unpack("<QQ", f.read(16))
            self.dtype = np.dtype(_DTYPES[code])
            self._len, self._s = struct.unpack("<QQ", f.read(16))
            (self._doc_count,) = struct.unpack("<Q", f.read(8))
            self.dim_offsets = np.frombuffer(
                f.read(8 * (self._len + 1)), dtype=np.int64)
            self.data_offsets = np.frombuffer(
                f.read(8 * (self._len + 1)), dtype=np.int64)
            self.sizes = np.frombuffer(f.read(8 * self._s), dtype=np.int64)
            self.doc_idx = np.frombuffer(
                f.read(8 * self._doc_count), dtype=np.int64)
            # an index without the doc_idx block (a historical layout)
            # parses with every section shifted 8 bytes: a well-formed file
            # has offsets anchored at 0 and nothing after doc_idx
            if (len(self.dim_offsets) != self._len + 1
                    or self.dim_offsets[0] != 0
                    or self.data_offsets[0] != 0
                    or len(self.doc_idx) != self._doc_count
                    or f.read(1) != b""):
                raise ValueError(
                    f"{path}: TNTIDX header does not match the doc_idx "
                    "layout (a truncated file, or an index written without "
                    "doc_idx); regenerate the index")
        self._file = None

    def _ensure_open(self):
        if self._file is None:
            self._file = open(data_file_path(self._prefix), "rb", buffering=0)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __len__(self):
        return self._len

    def __getitem__(self, idx: int) -> np.ndarray:
        self._ensure_open()
        start = self.dim_offsets[idx]
        end = self.dim_offsets[idx + 1]
        shape = tuple(self.sizes[start:end])
        count = int(np.prod(shape))
        self._file.seek(self.data_offsets[idx] * self._element_size)
        buf = self._file.read(count * self._element_size)
        return np.frombuffer(buf, dtype=self.dtype).reshape(shape)

    @staticmethod
    def exists(prefix: str) -> bool:
        return MMapIndexedDataset.exists(prefix)


class IndexedCachedDataset(IndexedDataset):
    """The legacy reader with chosen documents prefetched into RAM."""

    def __init__(self, prefix: str):
        super().__init__(prefix)
        self._cache = {}

    def prefetch(self, indices: Sequence[int]) -> None:
        for i in indices:
            if i not in self._cache:
                self._cache[i] = super().__getitem__(int(i))

    def __getitem__(self, idx: int) -> np.ndarray:
        if idx in self._cache:
            return self._cache[idx]
        return super().__getitem__(idx)


class IndexedDatasetBuilder:
    """Writer of the TNTIDX legacy format."""

    def __init__(self, out_prefix: str, dtype=np.int32):
        self._prefix = out_prefix
        self._dtype = np.dtype(dtype)
        self._data = open(data_file_path(out_prefix), "wb")
        self.data_offsets = [0]
        self.dim_offsets = [0]
        self.sizes: List[int] = []
        self.doc_idx = [0]

    def add_item(self, tokens: np.ndarray) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        self._data.write(arr.tobytes(order="C"))
        self.data_offsets.append(self.data_offsets[-1] + arr.size)
        self.sizes.extend(arr.shape)
        self.dim_offsets.append(self.dim_offsets[-1] + arr.ndim)

    def end_document(self) -> None:
        self.doc_idx.append(len(self.sizes))

    def add_document(self, tokens: np.ndarray) -> None:
        self.add_item(tokens)
        self.end_document()

    def merge_file_(self, other_prefix: str) -> None:
        other = IndexedDataset(other_prefix)
        if other.dtype != self._dtype:
            raise ValueError(f"cannot merge {other.dtype} items into a "
                             f"{self._dtype} builder")
        doc_offset = len(self.sizes)
        data_begin = self.data_offsets[-1]
        self.data_offsets.extend(
            (data_begin + other.data_offsets[1:]).tolist())
        self.sizes.extend(other.sizes.tolist())
        dim_begin = self.dim_offsets[-1]
        self.dim_offsets.extend((dim_begin + other.dim_offsets[1:]).tolist())
        self.doc_idx.extend((doc_offset + other.doc_idx[1:]).tolist())
        with open(data_file_path(other_prefix), "rb") as f:
            shutil.copyfileobj(f, self._data)

    def finalize(self) -> None:
        self._data.close()
        with open(index_file_path(self._prefix), "wb") as f:
            f.write(_LEGACY_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<QQ", dtype_code(self._dtype),
                                self._dtype.itemsize))
            f.write(struct.pack("<QQ", len(self.data_offsets) - 1,
                                len(self.sizes)))
            f.write(struct.pack("<Q", len(self.doc_idx)))
            f.write(np.asarray(self.dim_offsets, np.int64).tobytes())
            f.write(np.asarray(self.data_offsets, np.int64).tobytes())
            f.write(np.asarray(self.sizes, np.int64).tobytes())
            f.write(np.asarray(self.doc_idx, np.int64).tobytes())


# ---------------------------------------------------------------------------

def make_builder(out_prefix: str, impl: str = "mmap",
                 vocab_size: Optional[int] = None):
    dtype = best_dtype(vocab_size)
    if impl == "mmap":
        return MMapIndexedDatasetBuilder(out_prefix, dtype=dtype)
    return IndexedDatasetBuilder(out_prefix, dtype=dtype)


def make_dataset(prefix: str, impl: str = "mmap"):
    """A reader of ``prefix``: "mmap", "cached" or (any other) the lazy
    legacy reader."""
    if not MMapIndexedDataset.exists(prefix):
        raise FileNotFoundError(f"no indexed dataset at {prefix}")
    if impl == "mmap":
        return MMapIndexedDataset(prefix)
    if impl == "cached":
        return IndexedCachedDataset(prefix)
    return IndexedDataset(prefix)
