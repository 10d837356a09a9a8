// Native host-side hot paths for fastp_tpu: FASTQ tokenization into padded
// tensors, output serialization, and the sequential-adaptive known-adapter
// scan.  Exposed via a C ABI consumed through ctypes (io/native.py).
//
// The tokenizer reproduces the reference reader's record semantics
// (reference: src/fastqreader.cpp:219-347): lines end at \n, \r, or \r\n;
// empty/non-'@' lines before a record name are skipped; a bad '+' line or a
// seq/qual length mismatch stops the stream.
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <vector>
#include <string>
#include <algorithm>
#ifdef __AVX2__
#include <immintrin.h>
#endif

extern "C" {

// Parse records from buf[0:len). Only complete records are consumed unless
// is_final != 0 (then a trailing record without a final newline is accepted).
// Returns number of records parsed. *consumed is the byte offset after the
// last parsed record, *stopped is set to 1 when malformed input ended the
// stream (reference behavior: treat as EOF).
int64_t fq_tokenize(const uint8_t* buf, int64_t len, int is_final,
                    int64_t max_records, int64_t width, int phred64,
                    uint8_t* bases, uint8_t* quals, int32_t* lengths,
                    int64_t* name_off, int32_t* name_len,
                    int64_t* strand_off, int32_t* strand_len,
                    int64_t* consumed, int32_t* stopped, int32_t* need_wider) {
    int64_t pos = 0;
    int64_t n = 0;
    *stopped = 0;
    *need_wider = 0;
    *consumed = 0;

    // one memchr over the chunk decides the line-scan strategy: without any
    // '\r' every line ends at '\n' and glibc's vectorized memchr replaces
    // the per-byte two-terminator loop (~10x on this host's AVX-512 core)
    const bool has_cr = memchr(buf, '\r', (size_t)len) != nullptr;

    auto next_line = [&](int64_t& start, int64_t& llen) -> bool {
        // returns false if no complete line available
        if (pos >= len) return false;
        start = pos;
        if (!has_cr) {
            const void* hit = memchr(buf + pos, '\n', (size_t)(len - pos));
            if (!hit) {
                if (!is_final) return false;
                llen = len - start;
                pos = len;
                return true;
            }
            int64_t p = (const uint8_t*)hit - buf;
            llen = p - start;
            pos = p + 1;
            return true;
        }
        int64_t p = pos;
        while (p < len && buf[p] != '\n' && buf[p] != '\r') p++;
        if (p >= len && !is_final) return false;
        llen = p - start;
        // skip the terminator (handle \r\n)
        if (p < len) {
            if (buf[p] == '\r' && p + 1 < len && buf[p + 1] == '\n') p += 2;
            else p += 1;
        }
        pos = p;
        return true;
    };

    while (n < max_records) {
        int64_t save = pos;
        int64_t nstart, nlen;
        // skip empty / non-@ lines before the name
        bool have = false;
        while (true) {
            if (!next_line(nstart, nlen)) { pos = save; goto done; }
            if (nlen > 0 && buf[nstart] == '@') { have = true; break; }
            save = pos;  // consumed garbage lines stay consumed
        }
        if (!have) { pos = save; goto done; }
        int64_t sstart, slen, tstart, tlen, qstart, qlen;
        if (!next_line(sstart, slen)) { pos = save; goto done; }
        if (!next_line(tstart, tlen)) { pos = save; goto done; }
        if (!next_line(qstart, qlen)) { pos = save; goto done; }
        if (tlen == 0 || buf[tstart] != '+') {
            fprintf(stderr, "%.*s\nExpected '+', got %.*s\n"
                    "Your FASTQ may be invalid, please check the tail of your FASTQ file\n",
                    (int)nlen, buf + nstart, (int)tlen, buf + tstart);
            *stopped = 1;
            pos = save;
            goto done;
        }
        if (qlen != slen) {
            fprintf(stderr, "ERROR: sequence and quality have different length:\n"
                    "%.*s\n%.*s\n%.*s\n%.*s\n"
                    "Your FASTQ may be invalid, please check the tail of your FASTQ file\n",
                    (int)nlen, buf + nstart, (int)slen, buf + sstart,
                    (int)tlen, buf + tstart, (int)qlen, buf + qstart);
            *stopped = 1;
            pos = save;
            goto done;
        }
        if (slen > width) {
            *need_wider = (int32_t)slen;
            pos = save;
            goto done;
        }
        uint8_t* brow = bases + n * width;
        uint8_t* qrow = quals + n * width;
        memcpy(brow, buf + sstart, slen);
        memset(brow + slen, 0, width - slen);
        if (phred64) {
            for (int64_t i = 0; i < qlen; i++) {
                int q = (int)buf[qstart + i] - 31;
                qrow[i] = (uint8_t)(q < 33 ? 33 : q);
            }
        } else {
            memcpy(qrow, buf + qstart, qlen);
        }
        memset(qrow + qlen, 0, width - qlen);
        lengths[n] = (int32_t)slen;
        name_off[n] = nstart;
        name_len[n] = (int32_t)nlen;
        strand_off[n] = tstart;
        strand_len[n] = (int32_t)tlen;
        n++;
        *consumed = pos;
    }
done:
    return n;
}

// Serialize selected reads as FASTQ text.
//   namebuf: chunk text holding names/strands (offsets from fq_tokenize),
//            or NULL when names are provided via nameblob/name_off2.
//   seqsrc/qualsrc: [B, width] windowed content arrays
//   start/rlen: per-read window into the row
//   emit: per-read 0/1
// Returns bytes written (caller sizes `out` generously:
//   sum(name_len) + 2*width*B + 6*B upper bound).
// Chunked field copy: one 32B vector load/store per 32 bytes instead of a
// glibc memcpy dispatch per ~40-150B field (the per-call overhead dominates
// at FASTQ field sizes).  Overcopies up to 31B past o+n — legal because the
// caller's output cap reserves slack and later fields overwrite it — but
// never overREADS past s_end (falls back to memcpy near the source end).
static inline uint8_t* put_n(uint8_t* o, const uint8_t* s, int64_t n,
                             const uint8_t* s_end) {
    if (s + n + 31 <= s_end) {
        for (int64_t i = 0; i < n; i += 32)
            memcpy(o + i, s + i, 32);  // one vmovdqu pair
        return o + n;
    }
    memcpy(o, s, (size_t)n);
    return o + n;
}

int64_t fq_serialize(const uint8_t* namebuf,
                     const int64_t* name_off, const int32_t* name_len,
                     const uint8_t* strandbuf,
                     const int64_t* strand_off, const int32_t* strand_len,
                     const uint8_t* seqsrc, const uint8_t* qualsrc,
                     const int32_t* start, const int32_t* rlen,
                     const uint8_t* emit, int64_t n, int64_t width,
                     uint8_t* out) {
    uint8_t* o = out;
    const uint8_t* seq_end = seqsrc + n * width;
    const uint8_t* qual_end = qualsrc + n * width;
    // name/strand offsets index a shared chunk: the max reachable byte is
    // the max over rows (offsets are not sorted across R1/R2 interleave)
    int64_t nb_hi = 0, sb_hi = 0;
    for (int64_t i = 0; i < n; i++) {
        if (emit[i]) {
            if (name_off[i] + name_len[i] > nb_hi)
                nb_hi = name_off[i] + name_len[i];
            if (strand_off[i] + strand_len[i] > sb_hi)
                sb_hi = strand_off[i] + strand_len[i];
        }
    }
    const uint8_t* nb_end = namebuf + nb_hi;
    const uint8_t* sb_end = strandbuf + sb_hi;
    for (int64_t i = 0; i < n; i++) {
        if (!emit[i]) continue;
        o = put_n(o, namebuf + name_off[i], name_len[i], nb_end);
        *o++ = '\n';
        int32_t s = start[i], l = rlen[i];
        o = put_n(o, seqsrc + i * width + s, l, seq_end);
        *o++ = '\n';
        o = put_n(o, strandbuf + strand_off[i], strand_len[i], sb_end);
        *o++ = '\n';
        o = put_n(o, qualsrc + i * width + s, l, qual_end);
        *o++ = '\n';
    }
    return o - out;
}

// Duplication-filter hashing (reference: src/duplicate.cpp:91-133).
// Pair hash walks read1 bytes at positions 0..l1-1 then read2 bytes at
// positions l1..l1+l2-1: sum over prime[(pos*buf_num+i) & mask] *
// (code(base) + pos), reduced % buf_len_bits per buffer.  b2 may be NULL
// for single-end.  Sums stay < 2^44 (no uint64 wrap).
void dup_hash(const uint8_t* b1, const int32_t* l1,
              const uint8_t* b2, const int32_t* l2,
              int64_t B, int64_t W,
              const int64_t* primes, int32_t offset_mask,
              int32_t buf_num, uint64_t buf_len_bits,
              int64_t* out_positions /* [buf_num, B] */) {
    static int16_t codes[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; i++) codes[i] = 13;
        codes[(int)'A'] = 7; codes[(int)'T'] = 222;
        codes[(int)'C'] = 74; codes[(int)'G'] = 31;
        init = true;
    }
    // Hoist the prime lookups out of the inner loop: ptab[i][pos] is a
    // pure function of (pos, buf_num, offset_mask), so each buffer's sum
    // becomes a plain u64 dot product that the compiler vectorizes
    // (AVX-512DQ mullo_epi64); bit-identical to the reference walk.
    int64_t max_pos = b2 ? 2 * W : W;
    std::vector<uint64_t> ptab((size_t)buf_num * max_pos);
    for (int64_t pos = 0; pos < max_pos; pos++) {
        int64_t pbase = (pos * buf_num) & offset_mask;
        for (int i = 0; i < buf_num; i++)
            ptab[(size_t)i * max_pos + pos] =
                (uint64_t)primes[(pbase + i) & offset_mask];
    }
    std::vector<uint64_t> v((size_t)max_pos);
    for (int64_t r = 0; r < B; r++) {
        int64_t pos = 0;
        const uint8_t* seq = b1 + r * W;
        int len = l1[r];
        for (int half = 0; half < 2; half++) {
            for (int j = 0; j < len; j++, pos++)
                v[pos] = (uint64_t)(codes[seq[j]] + pos);
            if (b2 == nullptr || half == 1) break;
            seq = b2 + r * W;
            len = l2[r];
        }
        for (int i = 0; i < buf_num; i++) {
            const uint64_t* p = ptab.data() + (size_t)i * max_pos;
            uint64_t s = 0;
            for (int64_t j = 0; j < pos; j++)
                s += p[j] * v[j];
            out_positions[i * B + r] = (int64_t)(s % buf_len_bits);
        }
    }
}

// Sequential first-wins test-and-set over one Bloom buffer
// (reference: src/duplicate.cpp:154-167).  Overwrites is_dup so the LAST
// buffer's verdict survives, matching the reference's loop quirk.
void dup_apply(uint8_t* buf, const int64_t* pos, int64_t B, uint8_t* is_dup) {
    // Probe in ADDRESS order, not record order: the bit positions scatter
    // uniformly over a buffer of hundreds of MB, and the random walk pays
    // a TLB miss (and on lazily-backed VMs, a page fault) per probe.
    // Sorting (pos, idx) pairs (~2ms for 32k) makes the sweep sequential.
    // Semantics are unchanged: distinct positions commute, and ties keep
    // record order (idx tiebreak), so the first arrival still wins.
    std::vector<std::pair<int64_t, int64_t>> order((size_t)B);
    for (int64_t b = 0; b < B; b++) order[(size_t)b] = {pos[b], b};
    std::sort(order.begin(), order.end());
    for (int64_t k = 0; k < B; k++) {
        int64_t p = order[(size_t)k].first;
        int64_t b = order[(size_t)k].second;
        uint8_t bit = (uint8_t)(1u << (p & 7));
        uint8_t* cell = buf + (p >> 3);
        is_dup[b] = ((*cell & bit) != 0) ? 1 : 0;
        *cell |= bit;
    }
}

// Pack (base, qual) byte pairs into one byte per position for device
// upload: packed = (qual-33)*5 + code with code A=0 C=1 G=2 T=3 N=4;
// pad positions (base == 0) become 255.  Bytes outside {ACGTN, qual in
// [33, 83]} are recorded as exceptions (flat index, base, qual) that the
// device scatters over the unpacked tensors, keeping the path byte-exact
// for ANY input.  Returns the exception count, or -1 if it exceeds
// exc_cap (caller falls back to the raw two-tensor upload).
int64_t pack_bq(const uint8_t* bases, const uint8_t* quals, int64_t n,
                uint8_t* packed, int64_t exc_cap,
                int32_t* exc_idx, uint8_t* exc_base, uint8_t* exc_qual) {
    static int8_t code[256];
    static bool init = false;
    if (!init) {
        memset(code, -1, sizeof(code));
        code[(int)'A'] = 0; code[(int)'C'] = 1; code[(int)'G'] = 2;
        code[(int)'T'] = 3; code[(int)'N'] = 4;
        init = true;
    }
    int64_t n_exc = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t b = bases[i];
        if (b == 0) { packed[i] = 255; continue; }
        int c = code[b];
        int q = (int)quals[i] - 33;
        if (c < 0 || q < 0 || q > 50) {
            if (n_exc >= exc_cap) return -1;
            exc_idx[n_exc] = (int32_t)i;
            exc_base[n_exc] = b;
            exc_qual[n_exc] = quals[i];
            n_exc++;
            packed[i] = 0;  // placeholder ('A', q33); scatter overwrites
            continue;
        }
        packed[i] = (uint8_t)(q * 5 + c);
    }
    return n_exc;
}

// 4-bit input packing for device upload: code = qcode*4 + bcode per
// position, two positions per byte (low nibble = even position).  bcode
// maps ACGT->0..3; qcode indexes a persistent <=4-entry qual dictionary
// (learned first-come across batches so the device program sees one
// stable layout).  Anything else (N, IUPAC, lowercase, a 5th qual value)
// is recorded as an exception (flat index, base, qual) that the device
// scatters over the decoded tensors, keeping the path byte-exact for ANY
// input.  Pad positions (base == 0) encode 0; the device re-zeroes them
// from the length mask.  Returns the exception count, or -1 when it
// exceeds exc_cap (caller falls back to the 1-byte/position scheme).
// This halves the dominant H2D bytes vs pack_bq on modern binned-quality
// data (NovaSeq/NextSeq emit <=4 distinct quality values).
// Scalar inner loop over [i0, i1): |= nibbles into the pre-zeroed packed
// buffer, learn dict entries while nq < 4, record exceptions.  Returns the
// new exception count, or -1 on cap overflow (nq is flushed either way).
static int64_t nib_scalar(const uint8_t* bases, const uint8_t* quals,
                          int64_t i0, int64_t i1,
                          uint8_t* qdict, int* nq_io, int16_t* qcode,
                          const int8_t* bcode, uint8_t* packed,
                          int64_t exc_cap, int32_t* exc_idx,
                          uint8_t* exc_base, uint8_t* exc_qual,
                          int64_t n_exc) {
    int nq = *nq_io;
    for (int64_t i = i0; i < i1; i++) {
        uint8_t b = bases[i];
        if (b == 0) continue;  // pad: code 0, device re-zeroes by length
        int c = bcode[b];
        int q = qcode[quals[i]];
        if (q < 0 && c >= 0 && nq < 4) {  // learn a new qual value
            q = nq;
            qdict[nq] = quals[i];
            qcode[quals[i]] = (int16_t)nq;
            nq++;
        }
        if (c < 0 || q < 0) {
            if (n_exc >= exc_cap) { *nq_io = nq; return -1; }
            exc_idx[n_exc] = (int32_t)i;
            exc_base[n_exc] = b;
            exc_qual[n_exc] = quals[i];
            n_exc++;
            continue;  // placeholder code 0; the scatter overwrites
        }
        packed[i >> 1] |= (uint8_t)((q * 4 + c) << ((i & 1) * 4));
    }
    *nq_io = nq;
    return n_exc;
}

// 3-bit planar input packing: a 2-bit base plane (4 positions/byte,
// position 0 in bits 0-1) + a 1-bit qual plane (8 positions/byte) whose bit
// indexes a persistent 2-entry qual dictionary.  On two-level binned data
// (NovaSeq emits one dominant high qual + one low) this cuts H2D bytes 25%
// below pack_nib's 4 bits/position; off-dict quals and non-ACGT bases ride
// the same exception scatter, so the path stays byte-exact for any input.
// The dict is learned from a FREQUENCY HISTOGRAM of the first batch (not
// first-come like nib): a rare third qual ('#' at ~0.2%) seen early must
// not steal a dict slot from the second-most-common value.  Returns the
// exception count, or -1 on cap overflow (caller falls back to pack_nib).
// Scalar inner loop over [i0, i1): |= bits into the pre-zeroed planes.
static int64_t p3_scalar(const uint8_t* bases, const uint8_t* quals,
                         int64_t i0, int64_t i1,
                         const int16_t* qcode, const int8_t* bcode,
                         uint8_t* bplane, uint8_t* qplane,
                         int64_t exc_cap, int32_t* exc_idx,
                         uint8_t* exc_base, uint8_t* exc_qual,
                         int64_t n_exc) {
    for (int64_t i = i0; i < i1; i++) {
        uint8_t b = bases[i];
        if (b == 0) continue;  // pad: code 0, device re-zeroes by length
        int c = bcode[b];
        int q = qcode[quals[i]];
        if (c < 0 || q < 0) {
            if (n_exc >= exc_cap) return -1;
            exc_idx[n_exc] = (int32_t)i;
            exc_base[n_exc] = b;
            exc_qual[n_exc] = quals[i];
            n_exc++;
            continue;  // placeholder code 0; the scatter overwrites
        }
        bplane[i >> 2] |= (uint8_t)(c << ((i & 3) * 2));
        qplane[i >> 3] |= (uint8_t)(q << (i & 7));
    }
    return n_exc;
}

int64_t pack_p3(const uint8_t* bases, const uint8_t* quals, int64_t n,
                uint8_t* qdict, int32_t* qdict_n,
                uint8_t* bplane, uint8_t* qplane, int64_t exc_cap,
                int32_t* exc_idx, uint8_t* exc_base, uint8_t* exc_qual) {
    // C++11 magic static: thread-safe one-time init (a plain bool guard
    // raced when two threads made their first pack_p3 call concurrently)
    struct BCode {
        int8_t t[256];
        BCode() {
            memset(t, -1, sizeof(t));
            t[(int)'A'] = 0; t[(int)'C'] = 1;
            t[(int)'G'] = 2; t[(int)'T'] = 3;
        }
    };
    static const BCode bc;
    const int8_t* bcode = bc.t;
    int nq = *qdict_n;
    if (nq < 2) {
        // learn the dict from this batch's qual histogram: top-2 by count
        int64_t hist[256] = {0};
        for (int64_t i = 0; i < n; i++) hist[quals[i]]++;
        hist[0] = 0;  // pad
        for (int k = 0; k < nq; k++) hist[qdict[k]] = 0;  // already chosen
        while (nq < 2) {
            int best = -1;
            int64_t bc = 0;
            for (int v = 1; v < 256; v++)
                if (hist[v] > bc) { bc = hist[v]; best = v; }
            if (best < 0) break;  // fewer than 2 distinct quals in input
            qdict[nq++] = (uint8_t)best;
            hist[best] = 0;
        }
        if (nq == 1) { qdict[1] = qdict[0]; nq = 2; }  // degenerate alphabet
        *qdict_n = nq;
        if (nq < 2) return -1;  // empty batch: let the caller fall back
    }
    int16_t qcode[256];
    memset(qcode, -1, sizeof(qcode));
    qcode[qdict[0]] = 0;
    qcode[qdict[1]] = 1;
    memset(bplane, 0, (size_t)((n + 3) / 4));
    memset(qplane, 0, (size_t)((n + 7) / 8));
    int64_t n_exc = 0;
    int64_t i = 0;
#ifdef __AVX2__
    {
        // base low-nibble -> 2-bit code, as in pack_nib
        const __m128i lo_tbl128 = _mm_setr_epi8(
            0, 0, 0, 1, 3, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0);
        const __m128i chr_tbl128 = _mm_setr_epi8(
            'A', 'C', 'G', 'T', 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0);
        const __m256i lo_tbl = _mm256_broadcastsi128_si256(lo_tbl128);
        const __m256i chr_tbl = _mm256_broadcastsi128_si256(chr_tbl128);
        const __m256i nib_mask = _mm256_set1_epi8(0x0F);
        const __m256i zero = _mm256_setzero_si256();
        const __m256i qv0 = _mm256_set1_epi8((char)qdict[0]);
        const __m256i qv1 = _mm256_set1_epi8((char)qdict[1]);
        // stage 1: even + odd*4 per byte pair -> one 4-bit value per pair
        const __m256i pack2_mul = _mm256_set1_epi16(0x0401);
        const __m256i lane_fix = _mm256_setr_epi32(0, 1, 4, 5, 0, 0, 0, 0);
        // stage 2 (128-bit): pair_even + pair_odd*16 -> one byte per 4 pos
        const __m128i pack4_mul = _mm_set1_epi16(0x1001);
        const __m128i zero128 = _mm_setzero_si128();
        for (; i + 32 <= n; i += 32) {
            __m256i b = _mm256_loadu_si256((const __m256i*)(bases + i));
            __m256i q = _mm256_loadu_si256((const __m256i*)(quals + i));
            __m256i pad = _mm256_cmpeq_epi8(b, zero);
            __m256i bc = _mm256_shuffle_epi8(
                lo_tbl, _mm256_and_si256(b, nib_mask));
            __m256i expect = _mm256_shuffle_epi8(chr_tbl, bc);
            __m256i valid_b = _mm256_or_si256(
                _mm256_cmpeq_epi8(b, expect), pad);
            __m256i m0 = _mm256_cmpeq_epi8(q, qv0);
            __m256i m1 = _mm256_cmpeq_epi8(q, qv1);
            __m256i ok = _mm256_and_si256(
                valid_b, _mm256_or_si256(_mm256_or_si256(m0, m1), pad));
            if (_mm256_movemask_epi8(ok) != -1) {
                n_exc = p3_scalar(bases, quals, i, i + 32, qcode, bcode,
                                  bplane, qplane, exc_cap, exc_idx,
                                  exc_base, exc_qual, n_exc);
                if (n_exc < 0) return -1;
                continue;
            }
            // qual plane: one movemask bit per position (m1 is 0/0xFF and
            // never matches the 0-valued pad quals)
            uint32_t qbits = (uint32_t)_mm256_movemask_epi8(m1);
            memcpy(qplane + (i >> 3), &qbits, 4);
            // base plane: two maddubs rounds pack 32 codes into 8 bytes
            __m256i val = _mm256_andnot_si256(pad, bc);
            __m256i t = _mm256_maddubs_epi16(val, pack2_mul);
            __m256i r = _mm256_packus_epi16(t, zero);
            r = _mm256_permutevar8x32_epi32(r, lane_fix);
            __m128i r128 = _mm256_castsi256_si128(r);
            __m128i t2 = _mm_maddubs_epi16(r128, pack4_mul);
            __m128i p8 = _mm_packus_epi16(t2, zero128);
            _mm_storel_epi64((__m128i*)(bplane + (i >> 2)), p8);
        }
    }
#endif
    n_exc = p3_scalar(bases, quals, i, n, qcode, bcode, bplane, qplane,
                      exc_cap, exc_idx, exc_base, exc_qual, n_exc);
    return n_exc;
}

int64_t pack_nib(const uint8_t* bases, const uint8_t* quals, int64_t n,
                 uint8_t* qdict, int32_t* qdict_n,
                 uint8_t* packed, int64_t exc_cap,
                 int32_t* exc_idx, uint8_t* exc_base, uint8_t* exc_qual) {
    // thread-safe one-time init (see pack_p3's BCode note)
    struct BCode {
        int8_t t[256];
        BCode() {
            memset(t, -1, sizeof(t));
            t[(int)'A'] = 0; t[(int)'C'] = 1;
            t[(int)'G'] = 2; t[(int)'T'] = 3;
        }
    };
    static const BCode bc;
    const int8_t* bcode = bc.t;
    int16_t qcode[256];
    memset(qcode, -1, sizeof(qcode));
    int nq = *qdict_n;
    for (int k = 0; k < nq; k++) qcode[qdict[k]] = (int16_t)k;
    int64_t n_exc = 0;
    memset(packed, 0, (size_t)((n + 1) / 2));
    int64_t i = 0;
#ifdef __AVX2__
    // Learn the dict on a scalar prefix (steady state carries nq == 4 in
    // from the previous batch), then vectorize 32 positions -> 16 packed
    // bytes per iteration.  Any block with an off-alphabet base, an
    // unknown qual, or a just-partial dict falls back to the scalar loop
    // (which also records its exceptions).  ~10x the scalar byte loop —
    // this is the hottest host produce stage after the tokenizer.
    if (nq < 4 && n > 4096) {
        n_exc = nib_scalar(bases, quals, 0, 4096, qdict, &nq, qcode,
                           bcode, packed, exc_cap, exc_idx, exc_base,
                           exc_qual, n_exc);
        if (n_exc < 0) { *qdict_n = nq; return -1; }
        i = 4096;
    }
restart:
    if (nq >= 1) {
        const int nq_setup = nq;
        // base low-nibble -> 2-bit code ('A'1->0 'C'3->1 'G'7->2 'T'4->3)
        const __m128i lo_tbl128 = _mm_setr_epi8(
            0, 0, 0, 1, 3, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0);
        const __m128i chr_tbl128 = _mm_setr_epi8(
            'A', 'C', 'G', 'T', 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0);
        const __m256i lo_tbl = _mm256_broadcastsi128_si256(lo_tbl128);
        const __m256i chr_tbl = _mm256_broadcastsi128_si256(chr_tbl128);
        const __m256i nib_mask = _mm256_set1_epi8(0x0F);
        const __m256i zero = _mm256_setzero_si256();
        // unused dict slots compare against slot 0's value but are force-
        // disabled by en_k, so an unknown qual is invalid (scalar block
        // records the exception / learns it, then the loop re-setups)
        const __m256i qv0 = _mm256_set1_epi8((char)qdict[0]);
        const __m256i qv1 = _mm256_set1_epi8((char)(nq_setup > 1 ? qdict[1] : qdict[0]));
        const __m256i qv2 = _mm256_set1_epi8((char)(nq_setup > 2 ? qdict[2] : qdict[0]));
        const __m256i qv3 = _mm256_set1_epi8((char)(nq_setup > 3 ? qdict[3] : qdict[0]));
        const __m256i en1 = _mm256_set1_epi8(nq_setup > 1 ? (char)0xFF : 0);
        const __m256i en2 = _mm256_set1_epi8(nq_setup > 2 ? (char)0xFF : 0);
        const __m256i en3 = _mm256_set1_epi8(nq_setup > 3 ? (char)0xFF : 0);
        const __m256i one = _mm256_set1_epi8(1);
        const __m256i two = _mm256_set1_epi8(2);
        const __m256i three = _mm256_set1_epi8(3);
        // maddubs pairs (even*1 + odd*16): one packed byte per 16-bit lane
        const __m256i pack_mul = _mm256_set1_epi16(0x1001);
        const __m256i lane_fix = _mm256_setr_epi32(0, 1, 4, 5, 0, 0, 0, 0);
        for (; i + 32 <= n; i += 32) {
            __m256i b = _mm256_loadu_si256((const __m256i*)(bases + i));
            __m256i q = _mm256_loadu_si256((const __m256i*)(quals + i));
            __m256i pad = _mm256_cmpeq_epi8(b, zero);
            __m256i bc = _mm256_shuffle_epi8(
                lo_tbl, _mm256_and_si256(b, nib_mask));
            __m256i expect = _mm256_shuffle_epi8(chr_tbl, bc);
            __m256i valid_b = _mm256_or_si256(
                _mm256_cmpeq_epi8(b, expect), pad);
            __m256i m0 = _mm256_cmpeq_epi8(q, qv0);
            __m256i m1 = _mm256_and_si256(_mm256_cmpeq_epi8(q, qv1), en1);
            __m256i m2 = _mm256_and_si256(_mm256_cmpeq_epi8(q, qv2), en2);
            __m256i m3 = _mm256_and_si256(_mm256_cmpeq_epi8(q, qv3), en3);
            __m256i valid_q = _mm256_or_si256(
                _mm256_or_si256(m0, m1), _mm256_or_si256(m2, m3));
            __m256i ok = _mm256_and_si256(
                valid_b, _mm256_or_si256(valid_q, pad));
            if (_mm256_movemask_epi8(ok) != -1) {
                n_exc = nib_scalar(bases, quals, i, i + 32, qdict, &nq,
                                   qcode, bcode, packed, exc_cap, exc_idx,
                                   exc_base, exc_qual, n_exc);
                if (n_exc < 0) { *qdict_n = nq; return -1; }
                if (nq != nq_setup) { i += 32; goto restart; }
                continue;
            }
            // dict values are distinct -> masks are exclusive: OR-select
            __m256i qc = _mm256_or_si256(
                _mm256_or_si256(_mm256_and_si256(m1, one),
                                _mm256_and_si256(m2, two)),
                _mm256_and_si256(m3, three));
            __m256i val = _mm256_or_si256(
                _mm256_and_si256(_mm256_slli_epi16(qc, 2),
                                 _mm256_set1_epi8(0x0C)),
                bc);
            val = _mm256_andnot_si256(pad, val);
            __m256i t = _mm256_maddubs_epi16(val, pack_mul);
            __m256i r = _mm256_packus_epi16(t, zero);
            r = _mm256_permutevar8x32_epi32(r, lane_fix);
            _mm_storeu_si128((__m128i*)(packed + (i >> 1)),
                             _mm256_castsi256_si128(r));
        }
    }
#endif
    n_exc = nib_scalar(bases, quals, i, n, qdict, &nq, qcode, bcode,
                       packed, exc_cap, exc_idx, exc_base, exc_qual, n_exc);
    *qdict_n = nq;
    return n_exc;
}

// Known-adapter scan (reference: src/evaluator.cpp:207-293).
// adapters: concatenated adapter bytes; aoff/alen arrays of n_ad entries
// (lexicographically sorted, matching std::map iteration).
// Returns the winning adapter index or -1.
int32_t known_adapter_scan(const uint8_t* bases, const int32_t* lengths,
                           int64_t n_reads, int64_t width,
                           const uint8_t* adapters, const int64_t* aoff,
                           const int32_t* alen, int32_t n_ad,
                           int64_t* out_counts, int64_t* out_mismatches,
                           int64_t* out_checked_reads) {
    const int64_t MAX_CHECK_READS = 100000;
    const int64_t MAX_CHECK_BASES = MAX_CHECK_READS * 1000;
    const int64_t MAX_HIT = 1000;
    const int matchReq = 8;
    const int allowOneMismatchForEach = 16;

    std::vector<int64_t> counts(n_ad, 0), mism(n_ad, 0);
    int64_t checkedReads = 0, checkedBases = 0, curMax = 0;

    for (int64_t r = 0; r < n_reads; r++) {
        const uint8_t* rdata = bases + r * width;
        int rl = lengths[r];
        checkedReads++;
        checkedBases += rl;
        if (checkedReads > MAX_CHECK_READS || checkedBases > MAX_CHECK_BASES) break;
        if (curMax > MAX_HIT) break;
        for (int32_t ai = 0; ai < n_ad; ai++) {
            int al = alen[ai];
            if (al >= rl) continue;
            if (curMax > 20 && counts[ai] < curMax / 10) continue;
            const uint8_t* adata = adapters + aoff[ai];
            for (int p = 0; p < rl - matchReq; p++) {
                int cmplen = std::min(rl - p, al);
                int allowed = cmplen / allowOneMismatchForEach;
                int mm = 0;
                bool matched = true;
                for (int i = 0; i < cmplen; i++) {
                    if (adata[i] != rdata[i + p]) {
                        if (++mm > allowed) { matched = false; break; }
                    }
                }
                if (matched) {
                    counts[ai]++;
                    if (curMax < counts[ai]) curMax = counts[ai];
                    mism[ai] += mm;
                    break;
                }
            }
        }
    }

    for (int32_t ai = 0; ai < n_ad; ai++) {
        out_counts[ai] = counts[ai];
        out_mismatches[ai] = mism[ai];
    }
    *out_checked_reads = checkedReads;

    int32_t best = -1;
    int64_t maxCount = 0;
    for (int32_t ai = 0; ai < n_ad; ai++) {
        if (counts[ai] > maxCount) { best = ai; maxCount = counts[ai]; }
    }
    return best;
}

// 10-mer seed histogram (reference: src/evaluator.cpp:367-381): counts over
// positions 20..len-keylen-shiftTail with rolling 2-bit keys (N resets).
void seed_histogram(const uint8_t* bases, const int32_t* lengths,
                    int64_t n_reads, int64_t width, int shift_tail,
                    uint32_t* counts /* size 4^10 */) {
    static int8_t b2v[256];
    static bool init = false;
    if (!init) {
        memset(b2v, -1, sizeof(b2v));
        b2v[(int)'A'] = 0; b2v[(int)'T'] = 1; b2v[(int)'C'] = 2; b2v[(int)'G'] = 3;
        init = true;
    }
    const int keylen = 10;
    const int mask = (1 << (keylen * 2)) - 1;
    for (int64_t r = 0; r < n_reads; r++) {
        const uint8_t* s = bases + r * width;
        int rl = lengths[r];
        int key = -1;
        for (int p = 20; p <= rl - keylen - shift_tail; p++) {
            if (key >= 0) {
                int v = b2v[s[p + keylen - 1]];
                key = (v < 0) ? -1 : (((key << 2) & mask) + v);
            } else {
                key = 0;
                for (int i = p; i < p + keylen; i++) {
                    int v = b2v[s[i]];
                    if (v < 0) { key = -1; break; }
                    key = (key << 2) + v;
                }
            }
            if (key >= 0) counts[key]++;
        }
    }
}

// Collect (read, pos) hits of one 10-mer seed over positions
// 20..min(len-keylen-shift_tail, MAX_SEARCH-1) with rolling keys
// (reference: src/evaluator.cpp:476-507).  Returns hit count (capped).
int64_t collect_seed_hits(const uint8_t* bases, const int32_t* lengths,
                          int64_t n_reads, int64_t width,
                          int64_t seed, int shift_tail, int max_search,
                          int64_t cap, int32_t* hit_read, int32_t* hit_pos) {
    static int8_t b2v[256];
    static bool init = false;
    if (!init) {
        memset(b2v, -1, sizeof(b2v));
        b2v[(int)'A'] = 0; b2v[(int)'T'] = 1; b2v[(int)'C'] = 2; b2v[(int)'G'] = 3;
        init = true;
    }
    const int keylen = 10;
    const int mask = (1 << (keylen * 2)) - 1;
    int64_t n = 0;
    for (int64_t r = 0; r < n_reads && n < cap; r++) {
        const uint8_t* s = bases + r * width;
        int rl = lengths[r];
        int hi = rl - keylen - shift_tail;
        if (hi > max_search - 1) hi = max_search - 1;
        int key = -1;
        for (int p = 20; p <= hi; p++) {
            if (key >= 0) {
                int v = b2v[s[p + keylen - 1]];
                key = (v < 0) ? -1 : (((key << 2) & mask) + v);
            } else {
                key = 0;
                for (int i = p; i < p + keylen; i++) {
                    int v = b2v[s[i]];
                    if (v < 0) { key = -1; break; }
                    key = (key << 2) + v;
                }
            }
            if (key == (int)seed) {
                hit_read[n] = (int32_t)r;
                hit_pos[n] = p;
                if (++n >= cap) break;
            }
        }
    }
    return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Adapter-count recorder (reference: src/filterresult.cpp:115-183).
//
// The report's adapter maps receive one entry per trimmed read; with
// read-through PE trimming nearly every key is unique, so the Python
// per-row dict path costs ~30s per 2M pairs (per-row tobytes/decode).
// This keeps the maps native: an unordered_map for lookup plus an
// insertion-ordered vector so the exported dict iterates exactly like the
// Python dict would have.  Cap semantics are bit-exact with the
// reference: counters update before map logic; a NEW key is dropped when
// the map already holds >20000 entries (for pairs, a dropped adapter1
// also skips adapter2 — the reference's early return), and dropped when
// >5000 entries and the key is low-complexity.
#include <unordered_map>

namespace {

struct AdRecMap {
    std::unordered_map<std::string, int64_t> idx;   // key -> slot
    std::vector<std::pair<std::string, int64_t>> order;  // insertion order
};

// Log mode (one shard of a multi-process run): m1/m2 intern every distinct
// key uncapped, in first-occurrence order, and `events` holds one
// (id1, id2, count) triple per distinct add kind, in order of its first
// appearance, with the counts of its later adds summed in; -1 = that side
// of a pair is empty, -2 = a one-sided add to the other map.  Summing is
// exact: whether a map admits a key is decided at the key's first add and
// never changes (the map only grows), so a later add of the same kind only
// increments what its first add did.  Replaying every shard's events in
// shard order into one capped recorder therefore rebuilds exactly the maps
// of one process that read the whole input (the caps and the pair early
// return depend on the order of first appearances).  The log grows with
// the distinct adapter strings, not with the reads.
struct AdRec {
    AdRecMap m1, m2;
    bool log = false;
    std::vector<int64_t> events;
    std::unordered_map<uint64_t, int64_t> event_slot;  // (id1, id2) -> index
};

inline bool adrec_low_complexity(const uint8_t* s, int64_t len) {
    // reference: src/filterresult.cpp:115-122
    int64_t diff = 0;
    for (int64_t i = 1; i < len; i++) diff += (s[i] != s[i - 1]);
    return diff < len / 2;
}

// returns false when a NEW key was rejected by the 20000 cap (pair path
// uses this to skip adapter2, mirroring the reference's early return);
// low-complexity rejection of a new key returns... the reference returns
// there too, so both rejections report false.
inline bool adrec_add(AdRecMap& m, const uint8_t* s, int64_t len,
                      int64_t count) {
    std::string key(reinterpret_cast<const char*>(s), (size_t)len);
    auto it = m.idx.find(key);
    if (it != m.idx.end()) {
        m.order[(size_t)it->second].second += count;
        return true;
    }
    if ((int64_t)m.order.size() > 20000) return false;
    if ((int64_t)m.order.size() > 5000 && adrec_low_complexity(s, len))
        return false;
    m.idx.emplace(std::move(key), (int64_t)m.order.size());
    m.order.emplace_back(std::string(reinterpret_cast<const char*>(s),
                                     (size_t)len), count);
    return true;
}

inline int64_t adrec_intern(AdRecMap& m, const uint8_t* s, int64_t len) {
    std::string key(reinterpret_cast<const char*>(s), (size_t)len);
    auto it = m.idx.find(key);
    if (it != m.idx.end()) return it->second;
    int64_t id = (int64_t)m.order.size();
    m.idx.emplace(key, id);
    m.order.emplace_back(std::move(key), 0);
    return id;
}

inline void adrec_log(AdRec* r, int64_t id1, int64_t id2, int64_t count) {
    uint64_t kind = ((uint64_t)(id1 + 2) << 32) | (uint64_t)(id2 + 2);
    auto it = r->event_slot.find(kind);
    if (it != r->event_slot.end()) {
        r->events[(size_t)it->second + 2] += count;
        return;
    }
    r->event_slot.emplace(kind, (int64_t)r->events.size());
    r->events.push_back(id1);
    r->events.push_back(id2);
    r->events.push_back(count);
}

// one pair add: a capped NEW adapter1 key skips adapter2 (the reference's
// early return); an empty side skips only its own map
inline void adrec_pair(AdRec* r, const uint8_t* s1, int64_t l1,
                       const uint8_t* s2, int64_t l2, int64_t count) {
    if (r->log) {
        if (l1 > 0 || l2 > 0)
            adrec_log(r, l1 > 0 ? adrec_intern(r->m1, s1, l1) : -1,
                      l2 > 0 ? adrec_intern(r->m2, s2, l2) : -1, count);
        return;
    }
    if (l1 > 0 && !adrec_add(r->m1, s1, l1, count)) return;
    if (l2 > 0) adrec_add(r->m2, s2, l2, count);
}

inline void adrec_one(AdRec* r, const uint8_t* s, int64_t len, bool is_r2,
                      int64_t count) {
    if (len <= 0) return;
    if (r->log) {
        int64_t id = adrec_intern(is_r2 ? r->m2 : r->m1, s, len);
        adrec_log(r, is_r2 ? -2 : id, is_r2 ? id : -2, count);
        return;
    }
    adrec_add(is_r2 ? r->m2 : r->m1, s, len, count);
}

}  // namespace

extern "C" {

void* adrec_create() { return new AdRec(); }
void* adrec_create_log() {
    AdRec* r = new AdRec();
    r->log = true;
    return r;
}
void adrec_free(void* h) { delete static_cast<AdRec*>(h); }

// single-key add (reference: src/filterresult.cpp:124-153 map part only;
// the trimmed reads/bases counters stay in Python, vectorized)
void adrec_add_one(void* h, const uint8_t* s, int64_t len, int32_t is_r2,
                   int64_t count) {
    adrec_one(static_cast<AdRec*>(h), s, len, is_r2 != 0, count);
}

// bulk PE overlap-trim path (reference: src/filterresult.cpp:155-183):
// for each k in order, add ba1[rows[k], lo1[k]:hi1[k]] to map1 and
// ba2[rows[k], lo2[k]:hi2[k]] to map2; a capped NEW adapter1 key skips
// adapter2 (early return), and empty slices skip their map but not the
// other (empty adapter1 falls through to adapter2 like the reference's
// `if(!adapter1.empty())`).
void adrec_add_pairs(void* h, const uint8_t* ba1, int64_t W1,
                     const uint8_t* ba2, int64_t W2,
                     const int64_t* rows,
                     const int64_t* lo1, const int64_t* hi1,
                     const int64_t* lo2, const int64_t* hi2, int64_t n) {
    AdRec* r = static_cast<AdRec*>(h);
    for (int64_t k = 0; k < n; k++) {
        int64_t row = rows[k];
        int64_t a1 = lo1[k], b1 = hi1[k];
        int64_t a2 = lo2[k], b2 = hi2[k];
        adrec_pair(r, ba1 + row * W1 + a1, b1 > a1 ? b1 - a1 : 0,
                   ba2 + row * W2 + a2, b2 > a2 ? b2 - a2 : 0, 1);
    }
}

// bulk single-side adds: row slices ba[rows[k], lo[k]:hi[k]] in order,
// count 1 each, empty slices skipped (reference: filterresult.cpp:124-153
// map part; counters vectorize in Python)
void adrec_add_rows(void* h, const uint8_t* ba, int64_t W,
                    const int64_t* rows, const int64_t* lo,
                    const int64_t* hi, int64_t n, int32_t is_r2) {
    AdRec* r = static_cast<AdRec*>(h);
    for (int64_t k = 0; k < n; k++) {
        int64_t a = lo[k], b = hi[k];
        adrec_one(r, ba + rows[k] * W + a, b > a ? b - a : 0, is_r2 != 0, 1);
    }
}

// single pair add with explicit strings (non-bulk callers: corrected rows,
// synthesized prefixes); count applies to both maps; mirrors
// add_adapter_trimmed_pair exactly (reference: src/filterresult.cpp:155-183)
void adrec_add_pair_strs(void* h, const uint8_t* s1, int64_t l1,
                         const uint8_t* s2, int64_t l2, int64_t count) {
    adrec_pair(static_cast<AdRec*>(h), s1, l1, s2, l2, count);
}

// export protocol: size query, then fill caller buffers.  Entries stream
// in insertion order so the Python dict reconstruction iterates exactly
// like the incremental dict would have.
void adrec_export_size(void* h, int32_t is_r2, int64_t* n_entries,
                       int64_t* n_bytes) {
    AdRec* r = static_cast<AdRec*>(h);
    AdRecMap& m = is_r2 ? r->m2 : r->m1;
    int64_t nb = 0;
    for (auto& kv : m.order) nb += (int64_t)kv.first.size();
    *n_entries = (int64_t)m.order.size();
    *n_bytes = nb;
}

void adrec_export(void* h, int32_t is_r2, uint8_t* keys_concat,
                  int64_t* key_lens, int64_t* counts) {
    AdRec* r = static_cast<AdRec*>(h);
    AdRecMap& m = is_r2 ? r->m2 : r->m1;
    int64_t off = 0;
    for (size_t i = 0; i < m.order.size(); i++) {
        const std::string& k = m.order[i].first;
        memcpy(keys_concat + off, k.data(), k.size());
        key_lens[i] = (int64_t)k.size();
        counts[i] = m.order[i].second;
        off += (int64_t)k.size();
    }
}

// log-mode export: the (id1, id2, count) triples, 3 * adrec_log_size
// int64s; the interned keys come through adrec_export (counts 0)
int64_t adrec_log_size(void* h) {
    return (int64_t)static_cast<AdRec*>(h)->events.size() / 3;
}

void adrec_log_export(void* h, int64_t* out) {
    AdRec* r = static_cast<AdRec*>(h);
    memcpy(out, r->events.data(), r->events.size() * sizeof(int64_t));
}

// replay one shard's log (its interned keys per side + events) into a
// capped recorder, in order
void adrec_replay(void* h, const uint8_t* keys1, const int64_t* lens1,
                  int64_t n1, const uint8_t* keys2, const int64_t* lens2,
                  int64_t n2, const int64_t* events, int64_t n_events) {
    AdRec* r = static_cast<AdRec*>(h);
    std::vector<const uint8_t*> p1((size_t)n1), p2((size_t)n2);
    for (int64_t i = 0, off = 0; i < n1; off += lens1[i++]) p1[i] = keys1 + off;
    for (int64_t i = 0, off = 0; i < n2; off += lens2[i++]) p2[i] = keys2 + off;
    for (int64_t e = 0; e < n_events; e++) {
        int64_t id1 = events[3 * e], id2 = events[3 * e + 1];
        int64_t count = events[3 * e + 2];
        if (id2 == -2)
            adrec_one(r, p1[id1], lens1[id1], false, count);
        else if (id1 == -2)
            adrec_one(r, p2[id2], lens2[id2], true, count);
        else
            adrec_pair(r, id1 >= 0 ? p1[id1] : nullptr,
                       id1 >= 0 ? lens1[id1] : 0,
                       id2 >= 0 ? p2[id2] : nullptr,
                       id2 >= 0 ? lens2[id2] : 0, count);
    }
}

}  // extern "C"
