"""Host-side FASTQ streaming reader / writer.

Replicates the reference reader's record semantics
(reference: src/fastqreader.cpp:219-347):
  * lines end at \n, \r, or \r\n
  * a record's name line must start with '@'; empty/non-@ lines before a
    name are skipped
  * a missing/invalid '+' strand line or a seq/qual length mismatch prints a
    warning and ends the stream (treated as EOF)
Gzip input is streamed with zlib (multi-member supported); output gzip uses
zlib with the configured compression level.

This is the correctness-first pure-Python path; the C++ native tokenizer in
fastp_tpu/native is used automatically when built (see io/native.py).
"""
from __future__ import annotations

import os
import sys
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

CHUNK = 1 << 23  # 8MB, mirrors FQ_BUF_SIZE


class Record:
    __slots__ = ("name", "seq", "strand", "qual")

    def __init__(self, name: bytes, seq: bytes, strand: bytes, qual: bytes):
        self.name = name
        self.seq = seq
        self.strand = strand
        self.qual = qual


def _open_stream(filename: str):
    if filename == "/dev/stdin" or filename == "-":
        return sys.stdin.buffer, False
    return open(filename, "rb"), filename.endswith(".gz")


class _ZlibInflater:
    """Streaming multi-member gzip inflate via zlib (fallback path)."""

    def __init__(self):
        self._d = zlib.decompressobj(16 + 15)

    def feed(self, raw: bytes) -> bytes:
        data = self._d.decompress(raw)
        # multi-member gzip: restart on leftover
        while self._d.eof and self._d.unused_data:
            leftover = self._d.unused_data
            self._d = zlib.decompressobj(16 + 15)
            data += self._d.decompress(leftover)
        return data

    def finish(self) -> bytes:
        return self._d.flush()

    # bytearray-appending twins (ArrayFastqReader's in-place pending)
    def feed_into(self, raw: bytes, dest: bytearray) -> None:
        dest += self.feed(raw)

    def finish_into(self, dest: bytearray) -> None:
        dest += self.finish()


class _NativeGzInflater:
    """Throughput-grade gzip input: whole members inflate through
    libdeflate (~2-3x zlib) with multi-member restart; members too large
    for the buffer stream through zlib (native gz_reader in
    fastp_tpu/native/route_native.cpp; reference: the igzip loop in
    src/fastqreader.cpp:79-140)."""

    def __init__(self, lib):
        self._lib = lib
        self._h = lib.gz_reader_create()
        self._pend = bytearray()
        # ONE reusable inflate buffer: a fresh multi-MB numpy alloc per
        # feed costs a first-touch page-fault storm on hosts with slow
        # faults
        self._out = np.empty(1 << 23, np.uint8)
        self._consumed = np.zeros(1, np.int64)

    def _drive_into(self, final: bool, dest: bytearray) -> None:
        while True:
            n_in = len(self._pend)
            if n_in == 0 and not final:
                return
            if self._out.size < 4 * n_in:
                self._out = np.empty(max(4 * n_in, 2 * self._out.size),
                                     np.uint8)
            cap = self._out.size
            buf = np.frombuffer(self._pend if n_in else b"\0", np.uint8)
            n = self._lib.gz_reader_inflate(self._h, buf, n_in, int(final),
                                            self._out, cap, self._consumed)
            buf = None  # release the bytearray export before resizing it
            if n == -2:
                return  # buffer ends inside a member: feed more bytes
            if n < 0:
                raise OSError("corrupt gzip stream")
            c = int(self._consumed[0])
            if c:
                del self._pend[:c]
            if n > 0:
                dest += memoryview(self._out[:n])  # single in-place append
            if (n == 0 and c == 0) or (n < cap and not self._pend):
                return

    def feed_into(self, raw: bytes, dest: bytearray) -> None:
        self._pend += raw
        self._drive_into(False, dest)

    def finish_into(self, dest: bytearray) -> None:
        self._drive_into(True, dest)

    def feed(self, raw: bytes) -> bytes:
        ba = bytearray()
        self.feed_into(raw, ba)
        return bytes(ba)

    def finish(self) -> bytes:
        ba = bytearray()
        self.finish_into(ba)
        return bytes(ba)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.gz_reader_destroy(h)


def _make_inflater():
    import os
    if not os.environ.get("FASTP_TPU_NO_NATIVE_GZ"):
        from . import native
        lib = native.get_lib()
        if lib is not None and hasattr(lib, "gz_reader_create"):
            return _NativeGzInflater(lib)
    return _ZlibInflater()


class FastqReader:
    """Streaming FASTQ line reader with reference-compatible semantics."""

    # class-level defaults so hand-built instances (selftest) stay valid
    # when shard-range state is added
    _records_left = None
    _skip_lines = 0

    def __init__(self, filename: str, phred64: bool = False,
                 byte_range: Optional[Tuple[int, int]] = None,
                 record_range: Optional[Tuple[int, Optional[int]]] = None):
        self.filename = filename
        self.phred64 = phred64
        self._fh, self._zipped = _open_stream(filename)
        self._inf = _make_inflater() if self._zipped else None
        self._lines: List[bytes] = []
        self._lidx = 0
        self._tail = b""
        self._eof = False
        self._stopped = False
        self.bytes_read = 0  # compressed/file bytes consumed
        self._budget = None  # remaining bytes of a multi-host shard range
        if byte_range is not None:
            self._fh.seek(byte_range[0])
            self._budget = byte_range[1] - byte_range[0]
        self._skip_lines = 0
        self._records_left = None
        if record_range is not None:
            self._skip_lines = 4 * record_range[0]
            if record_range[1] is not None:
                self._records_left = record_range[1] - record_range[0]

    def _next_raw(self) -> bytes:
        n = CHUNK if self._budget is None else min(CHUNK, self._budget)
        raw = self._fh.read(n) if n > 0 else b""
        if self._budget is not None:
            self._budget -= len(raw)
        return raw

    def _fill(self) -> bool:
        """Read the next chunk and split into lines. Returns False at EOF."""
        while True:
            raw = self._next_raw()
            if not raw:
                data = self._inf.finish() if self._zipped else b""
                self._eof = True
                buf = self._tail + data
                self._tail = b""
                if not buf:
                    return False
                lines = self._normalize(buf).split(b"\n")
                self._lines = lines
                self._lidx = 0
                return True
            self.bytes_read += len(raw)
            data = self._inf.feed(raw) if self._zipped else raw
            buf = self._tail + data
            if not buf:
                continue
            norm = self._normalize(buf)
            lines = norm.split(b"\n")
            self._tail = lines.pop()  # possibly partial last line
            if not lines:
                continue
            self._lines = lines
            self._lidx = 0
            return True

    @staticmethod
    def _normalize(buf: bytes) -> bytes:
        if b"\r" in buf:
            buf = buf.replace(b"\r\n", b"\n").replace(b"\r", b"\n")
        return buf

    def _next_line(self) -> Optional[bytes]:
        while True:
            while self._lidx >= len(self._lines):
                if self._eof:
                    return None
                if not self._fill():
                    return None
            if self._skip_lines:  # record-range shard skip (bulk)
                take = min(self._skip_lines, len(self._lines) - self._lidx)
                self._lidx += take
                self._skip_lines -= take
                continue
            break
        line = self._lines[self._lidx]
        self._lidx += 1
        return line

    def read(self) -> Optional[Record]:
        """One record, or None at EOF / on malformed input (like the reference)."""
        if self._stopped:
            return None
        if self._records_left is not None:
            if self._records_left <= 0:
                return None
            self._records_left -= 1
        name = self._next_line()
        # skip empty / non-@ lines before the name
        while name is not None and (len(name) == 0 or name[0:1] != b"@"):
            name = self._next_line()
        if name is None or len(name) == 0:
            return None
        seq = self._next_line()
        strand = self._next_line()
        qual = self._next_line()
        if seq is None or strand is None or qual is None:
            self._stopped = True
            return None
        if len(strand) == 0 or strand[0:1] != b"+":
            sys.stderr.write(name.decode("latin-1") + "\n")
            sys.stderr.write("Expected '+', got %s\n" % strand.decode("latin-1"))
            sys.stderr.write("Your FASTQ may be invalid, please check the tail of your FASTQ file\n")
            self._stopped = True
            return None
        if len(qual) != len(seq):
            sys.stderr.write("ERROR: sequence and quality have different length:\n")
            for x in (name, seq, strand, qual):
                sys.stderr.write(x.decode("latin-1") + "\n")
            sys.stderr.write("Your FASTQ may be invalid, please check the tail of your FASTQ file\n")
            self._stopped = True
            return None
        if self.phred64:
            q = np.frombuffer(qual, dtype=np.uint8).astype(np.int16) - 31
            qual = np.maximum(q, 33).astype(np.uint8).tobytes()
        return Record(name, seq, strand, qual)

    def read_batch(self, n: int) -> List[Record]:
        out = []
        for _ in range(n):
            r = self.read()
            if r is None:
                break
            out.append(r)
        return out

    def close(self):
        if self._fh is not sys.stdin.buffer:
            self._fh.close()


def encode_batch(records: List[Record], width: int,
                 pre_trim: Optional[np.ndarray] = None):
    """Pack records into padded (bases, quals, lengths) uint8/int32 arrays.

    Reads longer than `width` raise (caller sizes width from the evaluator).
    """
    B = len(records)
    bases = np.zeros((B, width), np.uint8)
    quals = np.zeros((B, width), np.uint8)
    lengths = np.zeros((B,), np.int32)
    for i, r in enumerate(records):
        s = r.seq
        n = len(s)
        if n > width:
            raise ValueError("read length %d exceeds batch width %d" % (n, width))
        bases[i, :n] = np.frombuffer(s, np.uint8)
        quals[i, :n] = np.frombuffer(r.qual, np.uint8)
        lengths[i] = n
    return bases, quals, lengths


class ArrayBatch:
    """A batch of reads as padded arrays plus name/strand byte views.

    Two backing modes: (a) native-tokenized — ``chunk`` holds the raw FASTQ
    text and names/strands are (offset, len) views into it; (b) record-list —
    names/strands are bytes lists (chunk is None).  Either way, ``bases``,
    ``quals`` [n, width] u8 and ``lengths`` [n] i32 are ready for the device.
    """

    __slots__ = ("n", "width", "bases", "quals", "lengths", "chunk",
                 "name_off", "name_len", "strand_off", "strand_len",
                 "_names", "_strands", "_nameblob", "_nameblob_off",
                 "_nameblob_len")

    def __init__(self, n, width, bases, quals, lengths, chunk=None,
                 name_off=None, name_len=None, strand_off=None,
                 strand_len=None, names=None, strands=None):
        self.n = n
        self.width = width
        self.bases = bases
        self.quals = quals
        self.lengths = lengths
        self.chunk = chunk
        self.name_off = name_off
        self.name_len = name_len
        self.strand_off = strand_off
        self.strand_len = strand_len
        self._names = names
        self._strands = strands
        self._nameblob = None
        self._nameblob_off = None
        self._nameblob_len = None

    @classmethod
    def from_records(cls, records: List["Record"], width: int) -> "ArrayBatch":
        bases, quals, lengths = encode_batch(records, width)
        return cls(len(records), width, bases, quals, lengths,
                   names=[r.name for r in records],
                   strands=[r.strand for r in records])

    @property
    def names(self) -> List[bytes]:
        if self._names is None:
            if self._nameblob is not None:
                bb, off, ln = self._nameblob, self._nameblob_off, self._nameblob_len
                self._names = [bb[off[i]:off[i] + ln[i]].tobytes()
                               for i in range(self.n)]
            else:
                ch = self.chunk
                self._names = [
                    ch[self.name_off[i]:self.name_off[i] + self.name_len[i]].tobytes()
                    for i in range(self.n)]
        return self._names

    @property
    def strands(self) -> List[bytes]:
        if self._strands is None:
            ch = self.chunk
            self._strands = [
                ch[self.strand_off[i]:self.strand_off[i] + self.strand_len[i]].tobytes()
                for i in range(self.n)]
        return self._strands

    def set_names(self, names: List[bytes]):
        """Install modified names (UMI / fixMGI); invalidates the raw view."""
        self._names = names
        self._nameblob = None

    def set_name_buffers(self, blob: np.ndarray, off: np.ndarray,
                         lens: np.ndarray):
        """Install rebuilt names as (blob, offsets, lengths) arrays (native
        UMI path) without materializing a per-read bytes list."""
        self._nameblob = blob
        self._nameblob_off = np.ascontiguousarray(off, np.int64)
        self._nameblob_len = np.ascontiguousarray(lens, np.int32)
        self._names = None

    def name(self, i: int) -> bytes:
        if self._names is not None:
            return self._names[i]
        if self._nameblob is not None:
            o = self._nameblob_off[i]
            return self._nameblob[o:o + self._nameblob_len[i]].tobytes()
        o = self.name_off[i]
        return self.chunk[o:o + self.name_len[i]].tobytes()

    def strand(self, i: int) -> bytes:
        if self._strands is not None:
            return self._strands[i]
        o = self.strand_off[i]
        return self.chunk[o:o + self.strand_len[i]].tobytes()

    def seq_bytes(self, i: int) -> bytes:
        return self.bases[i, :self.lengths[i]].tobytes()

    def qual_bytes(self, i: int) -> bytes:
        return self.quals[i, :self.lengths[i]].tobytes()

    def seqs(self) -> List[bytes]:
        return [self.seq_bytes(i) for i in range(self.n)]

    def head(self, m: int) -> "ArrayBatch":
        """First m rows (array views; name lists sliced if materialized)."""
        return ArrayBatch(
            m, self.width, self.bases[:m], self.quals[:m], self.lengths[:m],
            chunk=self.chunk,
            name_off=None if self.name_off is None else self.name_off[:m],
            name_len=None if self.name_len is None else self.name_len[:m],
            strand_off=None if self.strand_off is None else self.strand_off[:m],
            strand_len=None if self.strand_len is None else self.strand_len[:m],
            names=None if self._names is None else self._names[:m],
            strands=None if self._strands is None else self._strands[:m])

    def widen(self, width: int) -> "ArrayBatch":
        """Zero-pad rows out to a larger width (no-op if already wide enough)."""
        if width <= self.width:
            return self
        bases = np.zeros((self.n, width), np.uint8)
        quals = np.zeros((self.n, width), np.uint8)
        bases[:, :self.width] = self.bases
        quals[:, :self.width] = self.quals
        return ArrayBatch(
            self.n, width, bases, quals, self.lengths, chunk=self.chunk,
            name_off=self.name_off, name_len=self.name_len,
            strand_off=self.strand_off, strand_len=self.strand_len,
            names=self._names, strands=self._strands)

    def name_buffers(self):
        """(buf, off, len) arrays for native serialization."""
        if self._nameblob is not None and self._names is None:
            return self._nameblob, self._nameblob_off, self._nameblob_len
        if self._names is None and self.chunk is not None:
            return self.chunk, self.name_off, self.name_len
        if self._nameblob is None:
            names = self.names
            lens = np.array([len(x) for x in names], np.int32)
            offs = np.zeros(len(names), np.int64)
            np.cumsum(lens[:-1], out=offs[1:])
            self._nameblob = np.frombuffer(b"".join(names), np.uint8)
            self._nameblob_off = offs
            self._nameblob_len = lens
        return self._nameblob, self._nameblob_off, self._nameblob_len

    def strand_buffers(self):
        if self._strands is None and self.chunk is not None:
            return self.chunk, self.strand_off, self.strand_len
        strands = self.strands
        lens = np.array([len(x) for x in strands], np.int32)
        offs = np.zeros(len(strands), np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        return np.frombuffer(b"".join(strands), np.uint8), offs, lens


def _round_width32(n: int) -> int:
    return max(32, -(-n // 32) * 32)


class ArrayFastqReader:
    """Streaming reader that tokenizes straight into padded arrays via the
    native C++ tokenizer (fastp_tpu/native/fastq_native.cpp)."""

    def __init__(self, filename: str, phred64: bool = False,
                 byte_range: Optional[Tuple[int, int]] = None,
                 record_range: Optional[Tuple[int, Optional[int]]] = None):
        from . import native
        self._native = native
        assert native.get_lib() is not None
        self.filename = filename
        self.phred64 = phred64
        self._fh, self._zipped = _open_stream(filename)
        self._inf = _make_inflater() if self._zipped else None
        # bytearray: += appends in place (amortized), where immutable
        # bytes re-copied the whole pending buffer per append.  Rebound
        # (never resized) after tokenize so live batch chunk views stay
        # pinned to the old object.
        self._pending = bytearray()
        self._eof = False
        self._stopped = False
        self.bytes_read = 0
        self._est = 280  # adaptive bytes-per-record estimate
        self._budget = None  # remaining bytes of a multi-host shard range
        if byte_range is not None:
            self._fh.seek(byte_range[0])
            self._budget = byte_range[1] - byte_range[0]
        # plain seekable files map whole: the tokenizer then reads straight
        # out of the page cache (zero userspace copies — the read()+bytes
        # concat path costs one full pass of memory traffic per batch)
        self._mm = None
        self._mm_off = self._mm_end = 0
        # FASTP_TPU_NO_MMAP: on hosts with slow first-touch faults
        # (virtualized memory) a fresh mmap of a multi-GB
        # input faults every page once per RUN; the read() path copies
        # into the (resident-server) process's already-faulted malloc
        # arena instead, so repeat jobs fault ~nothing
        if (not self._zipped and self._fh is not sys.stdin.buffer
                and record_range is None
                and not os.environ.get("FASTP_TPU_NO_MMAP")):
            try:
                import mmap as _mmap
                size = os.fstat(self._fh.fileno()).st_size
                if size > 0:
                    self._mm = _mmap.mmap(self._fh.fileno(), size,
                                          prot=_mmap.PROT_READ)
                    try:
                        self._mm.madvise(_mmap.MADV_SEQUENTIAL)
                    except (AttributeError, OSError):
                        pass
                    self._mm_buf = np.frombuffer(self._mm, np.uint8)
                    self._mm_off = byte_range[0] if byte_range else 0
                    self._mm_end = (byte_range[1] if byte_range else size)
            except (OSError, ValueError):
                self._mm = None
        # record-range shard of a non-seekable (gzip) stream: skip 4*start
        # lines, then stop after end-start records (end None = unbounded)
        self._skip_lines = 0
        self._records_left = None
        if record_range is not None:
            self._skip_lines = 4 * record_range[0]
            if record_range[1] is not None:
                self._records_left = record_range[1] - record_range[0]

    def _do_skip(self):
        """Drop self._skip_lines whole lines from the decompressed stream
        (bulk newline counting, no tokenization)."""
        while self._skip_lines > 0:
            if not self._pending:
                if self._eof:
                    self._skip_lines = 0
                    return
                self._read_more()
                continue
            buf = np.frombuffer(self._pending, np.uint8)
            nl = np.flatnonzero(buf == 10)
            buf = None  # release the export before slicing/appending
            if len(nl) >= self._skip_lines:
                self._pending = self._pending[int(nl[self._skip_lines - 1]) + 1:]
                self._skip_lines = 0
            elif len(nl):
                self._pending = self._pending[int(nl[-1]) + 1:]
                self._skip_lines -= len(nl)
            elif self._eof:
                self._pending = bytearray()
                self._skip_lines = 0
            else:
                self._read_more()

    def _read_more(self, want: Optional[int] = None):
        # For plain files, read everything the caller still needs in ONE
        # call: repeated CHUNK-sized `bytes +=` concats re-copy (and re-
        # page-fault) the whole pending buffer per append.  Gzip keeps
        # CHUNK-sized
        # compressed reads (the inflate ratio is unknown).
        n = CHUNK if self._zipped or want is None else max(CHUNK, want)
        if self._budget is not None:
            n = min(n, self._budget)
        raw = self._fh.read(n) if n > 0 else b""
        if self._budget is not None:
            self._budget -= len(raw)
        if not raw:
            self._eof = True
            if self._zipped:
                self._inf.finish_into(self._pending)
            return
        self.bytes_read += len(raw)
        if self._zipped:
            self._inf.feed_into(raw, self._pending)
        else:
            self._pending += raw

    def _read_batch_mmap(self, n: int, width: int) -> Optional[ArrayBatch]:
        """Tokenize directly out of the mapped file: no read() copy, no
        pending-buffer concat; the batch's chunk view pins the map."""
        if self._mm_off >= self._mm_end:
            return None
        while True:
            buf = self._mm_buf[self._mm_off:self._mm_end]
            (cnt, bases, quals, lengths, noff, nlen, soff, slen,
             consumed, stopped, need_wider) = self._native.tokenize(
                buf, True, n, width, self.phred64)
            if need_wider:
                width = _round_width32(need_wider)
                continue
            if stopped:
                self._stopped = True
            if cnt == 0:
                self._mm_off = self._mm_end
                return None
            batch = ArrayBatch(cnt, width, bases[:cnt], quals[:cnt],
                               lengths[:cnt], chunk=buf,
                               name_off=noff[:cnt], name_len=nlen[:cnt],
                               strand_off=soff[:cnt], strand_len=slen[:cnt])
            self._mm_off += consumed
            self.bytes_read += consumed
            if self._records_left is not None:
                self._records_left -= cnt
            return batch

    def read_batch(self, n: int, width: int) -> Optional[ArrayBatch]:
        """Exactly n records (less only at EOF/stop); None when exhausted.
        Width auto-grows for long reads; check ``batch.width``."""
        if self._stopped:
            return None
        if self._skip_lines:
            self._do_skip()
        if self._records_left is not None:
            if self._records_left <= 0:
                return None
            n = min(n, self._records_left)
        if self._mm is not None:
            return self._read_batch_mmap(n, width)
        while True:
            need = n * self._est + 4 * self._est
            while not self._eof and len(self._pending) < need:
                self._read_more(need - len(self._pending))
            buf = np.frombuffer(self._pending, np.uint8)
            (cnt, bases, quals, lengths, noff, nlen, soff, slen,
             consumed, stopped, need_wider) = self._native.tokenize(
                buf, self._eof, n, width, self.phred64)
            if need_wider:
                width = _round_width32(need_wider)
                continue
            if stopped:
                self._stopped = True
            if cnt == n or self._eof or stopped:
                if cnt == 0:
                    return None
                batch = ArrayBatch(cnt, width, bases[:cnt], quals[:cnt],
                                   lengths[:cnt], chunk=buf,
                                   name_off=noff[:cnt], name_len=nlen[:cnt],
                                   strand_off=soff[:cnt], strand_len=slen[:cnt])
                # REBIND (don't resize): buf/chunk pin the old bytearray
                self._pending = self._pending[consumed:]
                self._est = max(64, consumed // cnt + 16)
                if self._records_left is not None:
                    self._records_left -= cnt
                return batch
            # buffer held fewer than n complete records: read more and retry
            buf = None  # release the export so _read_more may append
            self._est = max(self._est + 64, int(self._est * 1.5))

    def close(self):
        if self._mm is not None:
            self._mm_buf = None
            try:
                self._mm.close()
            except BufferError:
                pass  # batch chunk views still alive; GC will unmap
            self._mm = None
        if self._fh is not sys.stdin.buffer:
            self._fh.close()


class PyBatchReader:
    """Record-based fallback with the ArrayFastqReader interface."""

    def __init__(self, filename: str, phred64: bool = False,
                 byte_range: Optional[Tuple[int, int]] = None,
                 record_range: Optional[Tuple[int, Optional[int]]] = None):
        self._reader = FastqReader(filename, phred64, byte_range, record_range)
        self.filename = filename

    @property
    def bytes_read(self):
        return self._reader.bytes_read

    def read_batch(self, n: int, width: int) -> Optional[ArrayBatch]:
        records = self._reader.read_batch(n)
        if not records:
            return None
        maxlen = max(len(r.seq) for r in records)
        if maxlen > width:
            width = _round_width32(maxlen)
        return ArrayBatch.from_records(records, width)

    def close(self):
        self._reader.close()


def open_batch_reader(filename: str, phred64: bool = False,
                      byte_range: Optional[Tuple[int, int]] = None,
                      record_range: Optional[Tuple[int, Optional[int]]] = None):
    from . import native
    if native.get_lib() is not None:
        return ArrayFastqReader(filename, phred64, byte_range, record_range)
    return PyBatchReader(filename, phred64, byte_range, record_range)


def count_records(filename: str) -> int:
    """Number of complete 4-line records (streams gzip; used to derive
    record-range shards of non-seekable inputs)."""
    fh, zipped = _open_stream(filename)
    inf = _make_inflater() if zipped else None
    lines = 0
    last = b"\n"
    while True:
        raw = fh.read(CHUNK)
        if not raw:
            data = inf.finish() if zipped else b""
        else:
            data = inf.feed(raw) if zipped else raw
        if data:
            lines += int(np.count_nonzero(np.frombuffer(data, np.uint8) == 10))
            last = data[-1:]
        if not raw:
            break
    if fh is not sys.stdin.buffer:
        fh.close()
    if last != b"\n":
        lines += 1  # unterminated final line still ends a record
    return lines // 4


class OutputWriter:
    """Buffered plain/gzip writer with an async flush thread.

    Mirrors the reference's per-output WriterThread (src/writerthread.cpp):
    gzip compression (zlib releases the GIL) and disk writes happen on a
    dedicated thread, overlapping with batch processing.  A bounded queue
    provides the same credit-style backpressure as the reference's
    PACK_IN_MEM_LIMIT.  Buffered semantics match src/writer.cpp:98-133
    (one gzip member per flushed buffer, like the libdeflate writer).
    """

    def __init__(self, filename: str, compression: int = 4, to_stdout: bool = False,
                 buffer_size: int = 1 << 22, async_io: bool = True):
        self.filename = filename
        self._stdout = to_stdout
        self._zipped = filename.endswith(".gz") and not to_stdout
        self._fh = sys.stdout.buffer if to_stdout else open(filename, "wb")
        self._level = compression
        self._buf: List[bytes] = []
        self._buflen = 0
        self._bufsize = buffer_size
        self._q = None
        self._thr = None
        self._err = None
        if async_io and not to_stdout:
            import queue
            import threading
            self._q = queue.Queue(maxsize=16)
            self._thr = threading.Thread(target=self._worker, daemon=True)
            self._thr.start()

    def _emit(self, blob: bytes):
        try:
            if self._zipped:
                # libdeflate one-member-per-buffer fast path (reference:
                # src/writer.cpp:110-133); zlib stream fallback
                from . import native as native_mod
                gz = None
                if native_mod.get_lib() is not None:
                    gz = native_mod.gzip_compress(blob, self._level)
                if gz is None:
                    co = zlib.compressobj(self._level, zlib.DEFLATED, 16 + 15)
                    gz = co.compress(blob) + co.flush()
                self._fh.write(gz)
            else:
                self._fh.write(blob)
        except Exception as e:  # surfaced at the next write()/close()
            self._err = e

    def _worker(self):
        while True:
            blob = self._q.get()
            if blob is None:
                break
            self._emit(blob)

    def write(self, data: bytes):
        if self._err is not None:
            raise self._err
        if not data:
            return
        self._buf.append(data)
        self._buflen += len(data)
        if self._buflen >= self._bufsize:
            self.flush()

    def flush(self):
        if not self._buf:
            return
        blob = b"".join(self._buf)
        self._buf = []
        self._buflen = 0
        if self._q is not None:
            self._q.put(blob)
        else:
            self._emit(blob)

    def close(self):
        self.flush()
        if self._q is not None:
            self._q.put(None)
            self._thr.join()
        if self._err is not None:
            raise self._err
        if not self._stdout:
            self._fh.close()
        else:
            self._fh.flush()


def serialize_records(names: List[bytes], seqs: List[bytes], strands: List[bytes],
                      quals: List[bytes]) -> bytes:
    parts = []
    for i in range(len(names)):
        parts.append(names[i])
        parts.append(b"\n")
        parts.append(seqs[i])
        parts.append(b"\n")
        parts.append(strands[i])
        parts.append(b"\n")
        parts.append(quals[i])
        parts.append(b"\n")
    return b"".join(parts)
