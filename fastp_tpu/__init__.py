"""fastp_tpu: FASTQ preprocessing on an accelerator with JAX."""

# Allocator hardening for the host's batch-sized buffers:
#  * M_MMAP_THRESHOLD (-3) = 64MB: keep batch-sized buffers in malloc
#    arenas instead of mmap/munmap-per-free, so pages stay resident.
#  * M_TRIM_THRESHOLD (-1) = 1GB: without this, NON-MAIN arenas (every
#    worker thread in the prep/upload/fetch pools gets one) shrink their
#    heaps back to the kernel on free() at the default 128KB threshold,
#    re-faulting the same pages every batch.
#  * glibc.malloc.hugetlb=1 for child processes (see __main__/bench): glibc
#    then MADV_HUGEPAGEs arena growth, turning 4KB faults into 2MB faults.
try:
    import ctypes as _ctypes
    _libc = _ctypes.CDLL(None)
    _libc.mallopt(-3, 64 << 20)   # M_MMAP_THRESHOLD
    _libc.mallopt(-1, 1 << 30)    # M_TRIM_THRESHOLD
except Exception:
    pass
