"""Fast multi-member gzip of a file via fastp_tpu's native libdeflate
compressor (one member per 8MB chunk), faster than the gzip CLI.  Used
by bench.py to build the gzipped-input corpus
inside the bench budget; falls back to the zlib module without the
native library."""
import sys
import zlib


def gzip_file(src, dst, level=1, chunk=8 << 20):
    try:
        from fastp_tpu.io import native as native_mod
        compress = native_mod.gzip_compress
        if native_mod.get_lib() is None:
            compress = None
    except Exception:
        compress = None
    with open(src, "rb", buffering=0) as fin, open(dst, "wb") as fout:
        while True:
            blob = fin.read(chunk)
            if not blob:
                break
            if compress is not None:
                fout.write(compress(blob, level))
            else:
                co = zlib.compressobj(level, wbits=31)
                fout.write(co.compress(blob) + co.flush())


if __name__ == "__main__":
    gzip_file(sys.argv[1], sys.argv[2],
              int(sys.argv[3]) if len(sys.argv) > 3 else 1)
