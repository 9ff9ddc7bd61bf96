// Native host runtime for hla_la_tpu.
//
// The reference implements its entire host pipeline in C++ (BamTools I/O,
// processBAM record handling, extensionAligner backtrace).  Here the
// framework keeps compute on the device and implements the host-side hot
// loops natively: BGZF block inflation, BAM record parsing into packed
// arrays, and batched banded-NW backtrace.  Exposed via a plain C ABI and
// loaded from Python with ctypes (hla_la_tpu/native.py); every entry point
// has a pure-Python fallback.
//
// Build: hla_la_tpu/native.py builds it on first use (see native/Makefile)

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <memory>
#include <vector>
#include <thread>
#include <atomic>
#include <zlib.h>
#if defined(__AVX512F__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------- BGZF
// Inflate an entire BGZF file image (sequence of gzip blocks with BC extra
// fields) into one buffer.  Returns malloc'd buffer in *out (caller frees
// with hla_free), size in *out_len.  Returns 0 on success.
int hla_bgzf_inflate_all(const uint8_t* data, int64_t len,
                         uint8_t** out, int64_t* out_len, int n_threads) {
    // pass 1: find block boundaries
    struct Block { int64_t cdata_off; int64_t cdata_len; int64_t isize;
                   uint32_t crc; };
    std::vector<Block> blocks;
    int64_t off = 0;
    int64_t total = 0;
    while (off + 12 <= len) {
        if (data[off] != 0x1f || data[off + 1] != 0x8b) return -1;
        uint16_t xlen;
        std::memcpy(&xlen, data + off + 10, 2);
        int64_t extra_off = off + 12;
        if (extra_off + xlen > len) return -2;
        int64_t bsize = -1;
        int64_t eo = extra_off;
        while (eo + 4 <= extra_off + xlen) {
            uint8_t si1 = data[eo], si2 = data[eo + 1];
            uint16_t slen;
            std::memcpy(&slen, data + eo + 2, 2);
            if (si1 == 66 && si2 == 67 && slen == 2) {
                uint16_t bs;
                std::memcpy(&bs, data + eo + 4, 2);
                bsize = (int64_t)bs + 1;
            }
            eo += 4 + slen;
        }
        if (bsize < 0) return -3;
        int64_t cdata_off = extra_off + xlen;
        int64_t cdata_len = bsize - 12 - xlen - 8;
        if (cdata_len < 0) return -4;  // corrupt BSIZE: would wrap uInt cast below
        if (cdata_off + cdata_len + 8 > len) return -4;
        uint32_t isize, crc;
        std::memcpy(&crc, data + cdata_off + cdata_len, 4);
        std::memcpy(&isize, data + cdata_off + cdata_len + 4, 4);
        if (isize > 0) {
            blocks.push_back({cdata_off, cdata_len, (int64_t)isize, crc});
            total += isize;
        }
        off += bsize;
    }
    uint8_t* buf = (uint8_t*)std::malloc(total ? total : 1);
    if (!buf) return -5;
    // prefix offsets
    std::vector<int64_t> outs(blocks.size() + 1, 0);
    for (size_t i = 0; i < blocks.size(); i++)
        outs[i + 1] = outs[i] + blocks[i].isize;

    int nt = n_threads > 0 ? n_threads : 1;
    std::vector<std::thread> threads;
    std::vector<int> errs(nt, 0);
    auto work = [&](int t) {
        for (size_t i = t; i < blocks.size(); i += nt) {
            z_stream zs{};
            inflateInit2(&zs, -15);
            zs.next_in = const_cast<uint8_t*>(data + blocks[i].cdata_off);
            zs.avail_in = (uInt)blocks[i].cdata_len;
            zs.next_out = buf + outs[i];
            zs.avail_out = (uInt)blocks[i].isize;
            int r = inflate(&zs, Z_FINISH);
            int64_t produced = (int64_t)zs.total_out;
            inflateEnd(&zs);
            if (r != Z_STREAM_END) { errs[t] = -6; return; }
            // verify the BGZF CRC32/ISIZE of the uncompressed payload —
            // a bit-flipped-but-still-inflatable block must fail loudly,
            // not decode to wrong bases (htslib semantics)
            if (produced != blocks[i].isize
                || crc32(0, buf + outs[i], (uInt)blocks[i].isize)
                   != blocks[i].crc) { errs[t] = -7; return; }
        }
    };
    for (int t = 0; t < nt; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
    for (int e : errs) if (e) { std::free(buf); return e; }
    *out = buf;
    *out_len = total;
    return 0;
}

void hla_free(void* p) { std::free(p); }

// ---------------------------------------------------------------- BAM parse
// Counts records in a decompressed BAM record stream (after header).
// Returns number of records, fills totals for variable-size fields.
int64_t hla_bam_count(const uint8_t* data, int64_t len,
                      int64_t* total_name_bytes, int64_t* total_seq_bytes,
                      int64_t* total_cigar_ops) {
    int64_t off = 0, n = 0, names = 0, seqs = 0, cigs = 0;
    while (off + 4 <= len) {
        int32_t bs;
        std::memcpy(&bs, data + off, 4);
        if (off + 4 + bs > len || bs < 32) break;
        const uint8_t* r = data + off + 4;
        uint8_t l_name = r[8];
        uint16_t n_cigar;
        std::memcpy(&n_cigar, r + 12, 2);
        int32_t l_seq;
        std::memcpy(&l_seq, r + 16, 4);
        // corrupted-stream guard: all variable fields must fit inside the
        // record's own block (mirrored in hla_bam_parse — keep in sync so
        // the caller's allocations match)
        if (l_name < 1 || l_seq < 0
            || 32 + (int64_t)l_name + 4 * (int64_t)n_cigar
               + (int64_t)(l_seq + 1) / 2 + (int64_t)l_seq > bs) break;
        names += l_name - 1;
        seqs += l_seq;
        cigs += n_cigar;
        n++;
        off += 4 + bs;
    }
    *total_name_bytes = names;
    *total_seq_bytes = seqs;
    *total_cigar_ops = cigs;
    return n;
}

static const char SEQ_DECODE[17] = "=ACMGRSVTWYHKDNB";

// Parses records into packed arrays (pre-allocated by the caller using
// hla_bam_count totals).  qual bytes come out phred+33 (0xFF run -> 0).
// Returns number of records parsed.
int64_t hla_bam_parse(const uint8_t* data, int64_t len,
                      int32_t* ref_id, int32_t* pos, uint8_t* mapq,
                      uint16_t* flag, int32_t* mate_ref_id, int32_t* mate_pos,
                      int32_t* tlen,
                      int64_t* name_off, uint8_t* name_buf,
                      int64_t* seq_off, uint8_t* seq_buf, uint8_t* qual_buf,
                      int64_t* cigar_off, uint32_t* cigar_buf) {
    int64_t off = 0, n = 0, no = 0, so = 0, co = 0;
    while (off + 4 <= len) {
        int32_t bs;
        std::memcpy(&bs, data + off, 4);
        if (off + 4 + bs > len || bs < 32) break;
        const uint8_t* r = data + off + 4;
        uint8_t l_name = r[8];
        uint16_t n_cigar;
        std::memcpy(&n_cigar, r + 12, 2);
        int32_t l_seq;
        std::memcpy(&l_seq, r + 16, 4);
        // guard BEFORE any output write: n may already equal the counted
        // total when the stream's tail is corrupt
        if (l_name < 1 || l_seq < 0
            || 32 + (int64_t)l_name + 4 * (int64_t)n_cigar
               + (int64_t)(l_seq + 1) / 2 + (int64_t)l_seq > bs) break;
        std::memcpy(&ref_id[n], r, 4);
        std::memcpy(&pos[n], r + 4, 4);
        mapq[n] = r[9];
        std::memcpy(&flag[n], r + 14, 2);
        std::memcpy(&mate_ref_id[n], r + 20, 4);
        std::memcpy(&mate_pos[n], r + 24, 4);
        std::memcpy(&tlen[n], r + 28, 4);
        const uint8_t* p = r + 32;
        name_off[n] = no;
        std::memcpy(name_buf + no, p, l_name - 1);
        no += l_name - 1;
        p += l_name;
        cigar_off[n] = co;
        std::memcpy(cigar_buf + co, p, (size_t)n_cigar * 4);
        co += n_cigar;
        p += (size_t)n_cigar * 4;
        seq_off[n] = so;
        for (int32_t i = 0; i < l_seq; i++) {
            uint8_t b = p[i / 2];
            seq_buf[so + i] = SEQ_DECODE[(i % 2 == 0) ? (b >> 4) : (b & 0xF)];
        }
        p += (l_seq + 1) / 2;
        bool no_qual = l_seq > 0 && p[0] == 0xFF;
        for (int32_t i = 0; i < l_seq; i++)
            qual_buf[so + i] = no_qual ? 0 : (uint8_t)(p[i] + 33);
        so += l_seq;
        n++;
        off += 4 + bs;
    }
    name_off[n] = no;
    seq_off[n] = so;
    cigar_off[n] = co;
    return n;
}

// ------------------------------------------------------------ NW backtrace
// Batched backtrace over pointer tensors [B, L+1, W] (bit layout of
// ops/banded_nw.py).  Emits per-job op lists into out_ops [B, max_ops, 3]
// (op, read_pos, ref_pos) in forward order; out_n[b] = op count.
void hla_nw_backtrace_batch(const uint8_t* pointers, int64_t B, int64_t L,
                            int64_t W, const int64_t* lens,
                            const int32_t* end_k, const int32_t* end_state,
                            int32_t* out_ops, int64_t max_ops,
                            int32_t* out_n) {
    for (int64_t b = 0; b < B; b++) {
        const uint8_t* ptr = pointers + b * (L + 1) * W;
        int64_t i = lens[b];
        int64_t k = end_k[b];
        int state = end_state[b];
        int32_t* ops = out_ops + b * max_ops * 3;
        int64_t n = 0;
        // emit reversed, then flip
        while ((i > 0 || state == 2) && n < max_ops) {
            if (k < 0 || k >= W) break;
            uint8_t pv = ptr[i * W + k];
            int64_t j = i + k;
            if (state == 0) {
                if (i == 0) break;
                ops[n * 3] = 0; ops[n * 3 + 1] = (int32_t)(i - 1);
                ops[n * 3 + 2] = (int32_t)(j - 1);
                state = pv & 3;
                i -= 1;
            } else if (state == 1) {
                ops[n * 3] = 1; ops[n * 3 + 1] = (int32_t)(i - 1);
                ops[n * 3 + 2] = (int32_t)j;
                state = ((pv >> 2) & 1) ? 1 : 0;
                i -= 1; k += 1;
            } else {
                ops[n * 3] = 2; ops[n * 3 + 1] = (int32_t)i;
                ops[n * 3 + 2] = (int32_t)(j - 1);
                state = ((pv >> 3) & 1) ? 2 : 0;
                k -= 1;
            }
            n++;
        }
        // reverse in place
        for (int64_t a = 0, z = n - 1; a < z; a++, z--) {
            for (int c = 0; c < 3; c++) {
                int32_t t = ops[a * 3 + c];
                ops[a * 3 + c] = ops[z * 3 + c];
                ops[z * 3 + c] = t;
            }
        }
        out_n[b] = (int32_t)n;
    }
}

}  // extern "C"

// ------------------------------------------------------------- NW forward
// Banded glocal affine NW forward pass — exact port of
// ops/banded_nw.py::banded_nw_forward (same scores, pointers, tie-breaks).
// reads: [B, L] codes 0-3 (>=4 pad); refs: [B, L+W]; outputs:
// scores/end_k/end_state [B], pointers [B, L+1, W].

template <int WT>
static void nw_one(const uint8_t* __restrict rd, const uint8_t* __restrict rf,
                   int64_t L, int64_t W_rt, int64_t len,
                   float s_match, float s_mismatch, float s_open, float s_ext,
                   float* __restrict D, float* __restrict nD,
                   float* __restrict IY, float* __restrict nIY,
                   float* __restrict IX, float* __restrict nIX,
                   float* __restrict sub, uint8_t* __restrict ok,
                   float* out_score, int32_t* out_k, int32_t* out_state,
                   uint8_t* __restrict ptr) {
    // WT > 0: compile-time band width (fully unrolled/vectorised);
    // WT == 0: generic runtime width
    const int64_t W = WT > 0 ? WT : W_rt;
    const float NEGF = -1e30f;
    for (int64_t k = 0; k < W; k++) { D[k] = 0.0f; IY[k] = NEGF; IX[k] = NEGF; }
    std::memset(ptr, 0, (size_t)W);  // row 0 only; rows 1..L are fully written
    float best = NEGF; int32_t best_k = 0, best_state = 0;
    auto harvest = [&](const float* d, const float* iy, const float* ix) {
        best = NEGF; best_k = 0; best_state = 0;
        const float* mats[3] = {d, iy, ix};
        for (int s2 = 0; s2 < 3; s2++)
            for (int64_t k = 0; k < W; k++) {
                float v = mats[s2][k];
                if (v > best) { best = v; best_state = s2; best_k = (int32_t)k; }
            }
    };
    if (len == 0) harvest(D, IY, IX);
    for (int64_t i = 1; i <= L; i++) {
        const uint8_t rc = rd[i - 1];
        const uint8_t* __restrict xrow = rf + (i - 1);
        uint8_t* __restrict prow = ptr + i * W;
        for (int64_t k = 0; k < W; k++) {
            uint8_t xc = xrow[k];
            ok[k] = xc < 4;
            float m = (xc == rc && rc < 4) ? s_match : s_mismatch;
            sub[k] = ok[k] ? m : NEGF;
        }
        for (int64_t k = 0; k < W; k++) {
            float d = D[k], iy = IY[k], ix = IX[k];
            float m12 = iy > ix ? iy : ix;
            float pb = d >= m12 ? d : m12;
            uint8_t m_src = d >= m12 ? 0 : (iy >= ix ? 1 : 2);
            nD[k] = pb + sub[k];
            prow[k] = m_src;
        }
        for (int64_t k = 0; k < W - 1; k++) {
            float oc = D[k + 1] + s_open;
            float ec = IY[k + 1] + s_ext;
            nIY[k] = oc > ec ? oc : ec;
            prow[k] |= (uint8_t)((ec > oc) << 2);
        }
        nIY[W - 1] = NEGF;
        nIX[0] = NEGF;
        float run = NEGF;
        for (int64_t k = 1; k < W; k++) {
            float oc = nD[k - 1] + s_open;
            float ec = run + s_ext;
            float v = oc > ec ? oc : ec;
            run = ok[k] ? v : NEGF;
            nIX[k] = run;
            prow[k] |= (uint8_t)((ec > oc) << 3);
        }
        std::swap(D, nD); std::swap(IY, nIY); std::swap(IX, nIX);
        if (i == len) harvest(D, IY, IX);
    }
    *out_score = best;
    *out_k = best_k;
    *out_state = best_state;
}

#if defined(__AVX512F__)
// AVX-512 row kernel for W = NV*16.  The lane-serial IX recurrence (a
// ~10-cycle dependency chain per lane that dominated nw_one's row cost) is
// replaced on clean rows (no N/pad in the window) by the closed form
//   IX[k] = max(open + (k-1)*ext + max_{j<=k-1}(nD[j] - j*ext), NEGF)
// — the segmented cummax of ops/banded_nw.py:232-257 with one segment,
// PLUS a final NEGF clamp reproducing the sequential recurrence's decayed
// floor (NEGF + c is absorbed to NEGF in float32, so the serial chain's
// floor stays exactly NEGF).  Exactness scope: identical to the serial
// kernel for every lane whose value stays above NEGF; lanes already
// driven below NEGF by an earlier masked row (nD ~ -2e30) can keep
// -2e30-class values where the serial chain would floor at -1e30 — both
// are in the filtered domain (production drops score <= -1e29, and row
// maxima still agree exactly because IX lane 0 is exactly NEGF in every
// implementation).  Integer-valued production scoring is required for
// the drift trick to be rounding-free (parity tests use the defaults).
// Rows containing N/pad lanes fall back to the serial scalar loop.
template <int NV>
static void nw_one_avx512(const uint8_t* __restrict rd,
                          const uint8_t* __restrict rf,
                          int64_t L, int64_t len,
                          float s_match, float s_mismatch, float s_open,
                          float s_ext,
                          float* out_score, int32_t* out_k,
                          int32_t* out_state, uint8_t* __restrict ptr) {
    constexpr int W = NV * 16;
    const float NEGF = -1e30f;
    const __m512 NEGV = _mm512_set1_ps(NEGF);
    const __m512 matchv = _mm512_set1_ps(s_match);
    const __m512 mismv = _mm512_set1_ps(s_mismatch);
    const __m512 openv = _mm512_set1_ps(s_open);
    const __m512 extv = _mm512_set1_ps(s_ext);
    const __m512i four = _mm512_set1_epi32(4);
    const __m512i one_i = _mm512_set1_epi32(1);
    const __m512i two_i = _mm512_set1_epi32(2);
    const __m512i idx15 = _mm512_set1_epi32(15);
    alignas(64) float rampb[W], rampm1b[W];
    for (int k = 0; k < W; k++) {
        rampb[k] = (float)k * s_ext;
        rampm1b[k] = (float)(k - 1) * s_ext;
    }
    __m512 rampv[NV], rampm1v[NV];
    for (int v = 0; v < NV; v++) {
        rampv[v] = _mm512_load_ps(rampb + v * 16);
        rampm1v[v] = _mm512_load_ps(rampm1b + v * 16);
    }
    __m512 D[NV], IY[NV], IX[NV];
    for (int v = 0; v < NV; v++) {
        D[v] = _mm512_setzero_ps();
        IY[v] = NEGV;
        IX[v] = NEGV;
    }
    std::memset(ptr, 0, (size_t)W);  // row 0 only; rows 1..L are fully written
    float best = NEGF; int32_t best_k = 0, best_state = 0;
    auto harvest = [&]() {
        alignas(64) float sb[3][W];
        for (int v = 0; v < NV; v++) {
            _mm512_store_ps(sb[0] + v * 16, D[v]);
            _mm512_store_ps(sb[1] + v * 16, IY[v]);
            _mm512_store_ps(sb[2] + v * 16, IX[v]);
        }
        best = NEGF; best_k = 0; best_state = 0;
        for (int s2 = 0; s2 < 3; s2++)
            for (int k = 0; k < W; k++)
                if (sb[s2][k] > best) {
                    best = sb[s2][k]; best_state = s2; best_k = k;
                }
    };
    if (len == 0) harvest();
    for (int64_t i = 1; i <= L; i++) {
        const uint8_t rc = rd[i - 1];
        const uint8_t* __restrict xrow = rf + (i - 1);
        uint8_t* __restrict prow = ptr + i * W;
        const __m512i rcv = _mm512_set1_epi32((int)rc);
        const bool rc_ok = rc < 4;
        __mmask16 okm[NV];
        __m512 nD[NV], nIY[NV], nIX[NV];
        __m512i pbyte[NV];
        bool allok = true;
        for (int v = 0; v < NV; v++) {
            __m128i bytes = _mm_loadu_si128(
                reinterpret_cast<const __m128i*>(xrow + v * 16));
            __m512i xi = _mm512_cvtepu8_epi32(bytes);
            okm[v] = _mm512_cmp_epu32_mask(xi, four, _MM_CMPINT_LT);
            allok &= (okm[v] == (__mmask16)0xFFFF);
            __mmask16 eqm = rc_ok ? _mm512_cmpeq_epi32_mask(xi, rcv)
                                  : (__mmask16)0;
            __m512 m = _mm512_mask_mov_ps(mismv, eqm, matchv);
            __m512 sub = _mm512_mask_mov_ps(NEGV, okm[v], m);
            __m512 m12 = _mm512_max_ps(IY[v], IX[v]);
            __m512 pb = _mm512_max_ps(D[v], m12);
            __mmask16 dge = _mm512_cmp_ps_mask(D[v], m12, _CMP_GE_OQ);
            __mmask16 iyge = _mm512_cmp_ps_mask(IY[v], IX[v], _CMP_GE_OQ);
            __m512i s12 = _mm512_mask_mov_epi32(two_i, iyge, one_i);
            pbyte[v] = _mm512_maskz_mov_epi32((__mmask16)~dge, s12);
            nD[v] = _mm512_add_ps(pb, sub);
        }
        // IY: from (i-1, k+1) — shift down one lane across groups
        for (int v = 0; v < NV; v++) {
            __m512i dn = v + 1 < NV ? _mm512_castps_si512(D[v + 1])
                                    : _mm512_castps_si512(NEGV);
            __m512i iyn = v + 1 < NV ? _mm512_castps_si512(IY[v + 1])
                                     : _mm512_castps_si512(NEGV);
            __m512 dsh = _mm512_castsi512_ps(_mm512_alignr_epi32(
                dn, _mm512_castps_si512(D[v]), 1));
            __m512 iysh = _mm512_castsi512_ps(_mm512_alignr_epi32(
                iyn, _mm512_castps_si512(IY[v]), 1));
            __m512 oc = _mm512_add_ps(dsh, openv);
            __m512 ec = _mm512_add_ps(iysh, extv);
            nIY[v] = _mm512_max_ps(oc, ec);
            __mmask16 iyb = _mm512_cmp_ps_mask(ec, oc, _CMP_GT_OQ);
            pbyte[v] = _mm512_mask_or_epi32(pbyte[v], iyb, pbyte[v],
                                            _mm512_set1_epi32(4));
        }
        if (allok) {
            // closed-form IX: drift, prefix-max (in-vector shifts + carry),
            // shift-by-one, undrift, clamp to the serial floor
            __m512 carry = NEGV;
            __m512 gm[NV];
            for (int v = 0; v < NV; v++) {
                __m512 g = _mm512_sub_ps(nD[v], rampv[v]);
                __m512i gi = _mm512_castps_si512(g);
                __m512i negi = _mm512_castps_si512(NEGV);
                g = _mm512_max_ps(g, _mm512_castsi512_ps(
                    _mm512_alignr_epi32(gi, negi, 15)));
                gi = _mm512_castps_si512(g);
                g = _mm512_max_ps(g, _mm512_castsi512_ps(
                    _mm512_alignr_epi32(gi, negi, 14)));
                gi = _mm512_castps_si512(g);
                g = _mm512_max_ps(g, _mm512_castsi512_ps(
                    _mm512_alignr_epi32(gi, negi, 12)));
                gi = _mm512_castps_si512(g);
                g = _mm512_max_ps(g, _mm512_castsi512_ps(
                    _mm512_alignr_epi32(gi, negi, 8)));
                g = _mm512_max_ps(g, carry);
                gm[v] = g;
                carry = _mm512_permutexvar_ps(idx15, g);
            }
            for (int v = 0; v < NV; v++) {
                __m512i prev = v > 0 ? _mm512_castps_si512(gm[v - 1])
                                     : _mm512_castps_si512(NEGV);
                __m512 gsh = _mm512_castsi512_ps(_mm512_alignr_epi32(
                    _mm512_castps_si512(gm[v]), prev, 15));
                __m512 cand = _mm512_add_ps(
                    _mm512_add_ps(openv, rampm1v[v]), gsh);
                cand = _mm512_max_ps(cand, NEGV);
                if (v == 0)
                    cand = _mm512_mask_mov_ps(cand, (__mmask16)1, NEGV);
                nIX[v] = cand;
            }
            for (int v = 0; v < NV; v++) {
                __m512i prevIX = v > 0 ? _mm512_castps_si512(nIX[v - 1])
                                       : _mm512_castps_si512(NEGV);
                __m512i prevD = v > 0 ? _mm512_castps_si512(nD[v - 1])
                                      : _mm512_castps_si512(NEGV);
                __m512 ixsh = _mm512_castsi512_ps(_mm512_alignr_epi32(
                    _mm512_castps_si512(nIX[v]), prevIX, 15));
                __m512 ndsh = _mm512_castsi512_ps(_mm512_alignr_epi32(
                    _mm512_castps_si512(nD[v]), prevD, 15));
                __m512 ec = _mm512_add_ps(ixsh, extv);
                __m512 oc = _mm512_add_ps(ndsh, openv);
                __mmask16 ixb = _mm512_cmp_ps_mask(ec, oc, _CMP_GT_OQ);
                if (v == 0) ixb = (__mmask16)(ixb & 0xFFFE);
                pbyte[v] = _mm512_mask_or_epi32(pbyte[v], ixb, pbyte[v],
                                                _mm512_set1_epi32(8));
                _mm512_mask_cvtepi32_storeu_epi8(prow + v * 16,
                                                 (__mmask16)0xFFFF,
                                                 pbyte[v]);
            }
        } else {
            // N/pad in the window: serial scalar IX for this row
            alignas(64) float ndb[W], nixb[W];
            for (int v = 0; v < NV; v++) {
                _mm512_store_ps(ndb + v * 16, nD[v]);
                _mm512_mask_cvtepi32_storeu_epi8(prow + v * 16,
                                                 (__mmask16)0xFFFF,
                                                 pbyte[v]);
            }
            nixb[0] = NEGF;
            float run = NEGF;
            for (int k = 1; k < W; k++) {
                float oc = ndb[k - 1] + s_open;
                float ec = run + s_ext;
                float m = oc > ec ? oc : ec;
                run = (okm[k >> 4] >> (k & 15)) & 1 ? m : NEGF;
                nixb[k] = run;
                prow[k] |= (uint8_t)((ec > oc) << 3);
            }
            for (int v = 0; v < NV; v++)
                nIX[v] = _mm512_load_ps(nixb + v * 16);
        }
        for (int v = 0; v < NV; v++) {
            D[v] = nD[v]; IY[v] = nIY[v]; IX[v] = nIX[v];
        }
        if (i == len) harvest();
    }
    *out_score = best;
    *out_k = best_k;
    *out_state = best_state;
}
#endif  // __AVX512F__

// Jobs-in-lanes NW forward: 16 jobs per __m512 lane group, SERIAL scalar
// recurrence order per lane — bit-exact vs nw_one<0> for EVERY row
// (including N/pad rows; stricter than the row-vectorised kernel above,
// whose closed-form IX relaxes the floor on filtered-domain lanes).  The
// band index k is the *iteration* axis, so any runtime W works.  Why:
// at W=32 the row kernel spends most of each row on cross-lane shifts +
// the prefix-max network — ~6.6 ns/cell end-to-end on ~100x32 jobs.
// Here the only serial dependency is the per-lane IX run (add+max+blend)
// and it is amortised over 16 jobs.  readsT/refsT are lane-major
// transposes ([pos][16]); pointer bytes stage in a [W][16] row buffer
// and transpose out per row.
#if defined(__AVX512F__)
static void nw_lanes16_avx512(
    const uint8_t* __restrict readsT,   // [L][16]
    const uint8_t* __restrict refsT,    // [L+W][16]
    const int64_t* __restrict lens,     // [16] (inactive lanes: 0)
    int64_t L, int64_t W, int n_active,
    float s_match, float s_mismatch, float s_open, float s_ext,
    float* __restrict st,               // scratch [6*W*16] floats, 64-aligned
    uint8_t* __restrict rowp,           // scratch [W*16], 64-aligned
    float* out_scores, int32_t* out_k, int32_t* out_state,   // [n_active]
    uint8_t* out_ptr, int64_t ptr_stride) {  // job j ptr at out_ptr+j*stride
    const float NEGF = -1e30f;
    const __m512 NEGV = _mm512_set1_ps(NEGF);
    const __m512 matchv = _mm512_set1_ps(s_match);
    const __m512 mismv = _mm512_set1_ps(s_mismatch);
    const __m512 openv = _mm512_set1_ps(s_open);
    const __m512 extv = _mm512_set1_ps(s_ext);
    const __m512i four = _mm512_set1_epi32(4);
    const __m512i one_i = _mm512_set1_epi32(1);
    const __m512i two_i = _mm512_set1_epi32(2);
    // stride pads one vector per array: at W=32 the 2 KB power-of-two
    // array spacing cost ~1.8x via L1 set aliasing (measured 0.76 vs
    // 1.37 Gcells/s at W=33 on the same job set)
    const int64_t AS = (W + 1) * 16;
    float* D = st;            float* IY = st + AS;
    float* IX = st + 2 * AS;
    float* nD = st + 3 * AS;  float* nIY = st + 4 * AS;
    float* nIX = st + 5 * AS;
    for (int64_t k = 0; k < W; k++) {
        _mm512_store_ps(D + k * 16, _mm512_setzero_ps());
        _mm512_store_ps(IY + k * 16, NEGV);
        _mm512_store_ps(IX + k * 16, NEGV);
    }
    for (int j = 0; j < n_active; j++)
        std::memset(out_ptr + j * ptr_stride, 0, (size_t)W);  // row 0
    __m512 bestv = NEGV;
    __m512i bestk = _mm512_setzero_si512();
    __m512i bests = _mm512_setzero_si512();
    __mmask16 done = 0;
    // harvest lanes in `m` with the scalar kernel's tie order (state
    // outer, k inner, strict >)
    auto harvest = [&](__mmask16 m) {
        const float* mats[3] = {D, IY, IX};
        __m512 hb = NEGV;
        __m512i hk = _mm512_setzero_si512(), hs = _mm512_setzero_si512();
        for (int s2 = 0; s2 < 3; s2++)
            for (int64_t k = 0; k < W; k++) {
                __m512 v = _mm512_load_ps(mats[s2] + k * 16);
                __mmask16 gt = _mm512_cmp_ps_mask(v, hb, _CMP_GT_OQ);
                hb = _mm512_mask_mov_ps(hb, gt, v);
                hk = _mm512_mask_mov_epi32(hk, gt,
                                           _mm512_set1_epi32((int)k));
                hs = _mm512_mask_mov_epi32(hs, gt, _mm512_set1_epi32(s2));
            }
        bestv = _mm512_mask_mov_ps(bestv, m, hb);
        bestk = _mm512_mask_mov_epi32(bestk, m, hk);
        bests = _mm512_mask_mov_epi32(bests, m, hs);
        done |= m;
    };
    __mmask16 len0 = 0;
    for (int j = 0; j < 16; j++) if (lens[j] == 0) len0 |= (1u << j);
    if (len0) harvest(len0);
    for (int64_t i = 1; i <= L; i++) {
        __m512i rc = _mm512_cvtepu8_epi32(_mm_load_si128(
            reinterpret_cast<const __m128i*>(readsT + (i - 1) * 16)));
        __mmask16 rc_ok = _mm512_cmp_epu32_mask(rc, four, _MM_CMPINT_LT);
        __m512 run = NEGV;
        __m512 nd_prev = NEGV;
        for (int64_t k = 0; k < W; k++) {
            __m512i xc = _mm512_cvtepu8_epi32(_mm_load_si128(
                reinterpret_cast<const __m128i*>(refsT + (i - 1 + k) * 16)));
            __mmask16 okm = _mm512_cmp_epu32_mask(xc, four, _MM_CMPINT_LT);
            __mmask16 eqm = _mm512_mask_cmpeq_epi32_mask(rc_ok, xc, rc);
            __m512 sub = _mm512_mask_mov_ps(
                NEGV, okm, _mm512_mask_mov_ps(mismv, eqm, matchv));
            __m512 d = _mm512_load_ps(D + k * 16);
            __m512 iy = _mm512_load_ps(IY + k * 16);
            __m512 ix = _mm512_load_ps(IX + k * 16);
            __m512 m12 = _mm512_max_ps(iy, ix);
            __m512 pb = _mm512_max_ps(d, m12);
            __mmask16 dge = _mm512_cmp_ps_mask(d, m12, _CMP_GE_OQ);
            __mmask16 iyge = _mm512_cmp_ps_mask(iy, ix, _CMP_GE_OQ);
            __m512i pbits = _mm512_maskz_mov_epi32(
                (__mmask16)~dge, _mm512_mask_mov_epi32(two_i, iyge, one_i));
            __m512 nd = _mm512_add_ps(pb, sub);
            _mm512_store_ps(nD + k * 16, nd);
            if (k < W - 1) {
                __m512 oc = _mm512_add_ps(_mm512_load_ps(D + (k + 1) * 16),
                                          openv);
                __m512 ec = _mm512_add_ps(_mm512_load_ps(IY + (k + 1) * 16),
                                          extv);
                _mm512_store_ps(nIY + k * 16, _mm512_max_ps(oc, ec));
                __mmask16 iyb = _mm512_cmp_ps_mask(ec, oc, _CMP_GT_OQ);
                pbits = _mm512_mask_or_epi32(pbits, iyb, pbits,
                                             _mm512_set1_epi32(4));
            } else {
                _mm512_store_ps(nIY + k * 16, NEGV);
            }
            if (k == 0) {
                _mm512_store_ps(nIX, NEGV);
            } else {
                __m512 oc2 = _mm512_add_ps(nd_prev, openv);
                __m512 ec2 = _mm512_add_ps(run, extv);
                run = _mm512_mask_mov_ps(NEGV, okm,
                                         _mm512_max_ps(oc2, ec2));
                _mm512_store_ps(nIX + k * 16, run);
                __mmask16 ixb = _mm512_cmp_ps_mask(ec2, oc2, _CMP_GT_OQ);
                pbits = _mm512_mask_or_epi32(pbits, ixb, pbits,
                                             _mm512_set1_epi32(8));
            }
            nd_prev = nd;
            _mm512_mask_cvtepi32_storeu_epi8(rowp + k * 16,
                                             (__mmask16)0xFFFF, pbits);
        }
        std::swap(D, nD); std::swap(IY, nIY); std::swap(IX, nIX);
        // transpose the staged [W][16] pointer bytes to per-job rows
        for (int j = 0; j < n_active; j++) {
            uint8_t* pj = out_ptr + j * ptr_stride + i * W;
            for (int64_t k = 0; k < W; k++) pj[k] = rowp[k * 16 + j];
        }
        __mmask16 fin = 0;
        for (int j = 0; j < 16; j++)
            if (lens[j] == i) fin |= (1u << j);
        if (fin) harvest(fin);
    }
    alignas(64) float bb[16];
    alignas(64) int32_t kk[16], ss[16];
    _mm512_store_ps(bb, bestv);
    _mm512_store_si512(reinterpret_cast<__m512i*>(kk), bestk);
    _mm512_store_si512(reinterpret_cast<__m512i*>(ss), bests);
    for (int j = 0; j < n_active; j++) {
        out_scores[j] = bb[j];
        out_k[j] = kk[j];
        out_state[j] = ss[j];
    }
}
#endif  // __AVX512F__

extern "C" void hla_nw_forward(
    const uint8_t* reads, const int64_t* lens, const uint8_t* refs,
    int64_t B, int64_t L, int64_t W,
    float s_match, float s_mismatch, float s_open, float s_ext,
    float* out_scores, int32_t* out_k, int32_t* out_state,
    uint8_t* out_ptr, int n_threads) {
    int nt = n_threads > 0 ? n_threads : 1;
    std::vector<std::thread> threads;
#if defined(__AVX512F__)
    // jobs-in-lanes kernel for band widths without a template
    // specialisation (6-8x the generic scalar loop; the band-vectorised
    // row kernel below stays faster at the templated widths — measured
    // 1.17 vs 0.95 Gcells/s at W=32)
    const bool w_templated = (W == 16 || W == 32 || W == 48 || W == 64
                              || W == 128);
    if (!w_templated) {
        int64_t n_groups = (B + 15) / 16;
        auto workl = [=](int t) {
            auto al64 = [](void* p) {
                return (reinterpret_cast<uintptr_t>(p) + 63)
                       & ~static_cast<uintptr_t>(63);
            };
            std::vector<float> stv(6 * (W + 1) * 16 + 16);
            std::vector<uint8_t> rdv(L * 16 + 64), rfv((L + W) * 16 + 64),
                                 rpv(W * 16 + 64);
            float* st = reinterpret_cast<float*>(al64(stv.data()));
            uint8_t* rdT = reinterpret_cast<uint8_t*>(al64(rdv.data()));
            uint8_t* rfT = reinterpret_cast<uint8_t*>(al64(rfv.data()));
            uint8_t* rowp = reinterpret_cast<uint8_t*>(al64(rpv.data()));
            alignas(64) int64_t lens16[16];
            for (int64_t g = t; g < n_groups; g += nt) {
                const int64_t b0 = g * 16;
                const int na = (int)std::min<int64_t>(16, B - b0);
                for (int j = 0; j < 16; j++)
                    lens16[j] = j < na ? lens[b0 + j] : 0;
                for (int j = 0; j < na; j++) {
                    const uint8_t* rs = reads + (b0 + j) * L;
                    const uint8_t* fs = refs + (b0 + j) * (L + W);
                    for (int64_t i = 0; i < L; i++) rdT[i * 16 + j] = rs[i];
                    for (int64_t p = 0; p < L + W; p++)
                        rfT[p * 16 + j] = fs[p];
                }
                for (int j = na; j < 16; j++) {
                    for (int64_t i = 0; i < L; i++) rdT[i * 16 + j] = 4;
                    for (int64_t p = 0; p < L + W; p++) rfT[p * 16 + j] = 4;
                }
                nw_lanes16_avx512(rdT, rfT, lens16, L, W, na,
                                  s_match, s_mismatch, s_open, s_ext,
                                  st, rowp,
                                  out_scores + b0, out_k + b0,
                                  out_state + b0,
                                  out_ptr + b0 * (L + 1) * W,
                                  (L + 1) * W);
            }
        };
        for (int t = 0; t < nt; t++) threads.emplace_back(workl, t);
        for (auto& th : threads) th.join();
        return;
    }
#endif
    auto work = [=](int t) {
        std::vector<float> buf(6 * W), subv(W);
        std::vector<uint8_t> okv(W);
        auto run_all = [&](auto fn) {
            for (int64_t b = t; b < B; b += nt) {
                fn(reads + b * L, refs + b * (L + W), L, W, lens[b],
                   s_match, s_mismatch, s_open, s_ext,
                   buf.data(), buf.data() + W,
                   buf.data() + 2 * W, buf.data() + 3 * W,
                   buf.data() + 4 * W, buf.data() + 5 * W,
                   subv.data(), okv.data(),
                   out_scores + b, out_k + b, out_state + b,
                   out_ptr + b * (L + 1) * W);
            }
        };
#if defined(__AVX512F__)
        auto run_512 = [&](auto fn) {
            for (int64_t b = t; b < B; b += nt)
                fn(reads + b * L, refs + b * (L + W), L, lens[b],
                   s_match, s_mismatch, s_open, s_ext,
                   out_scores + b, out_k + b, out_state + b,
                   out_ptr + b * (L + 1) * W);
        };
        switch (W) {
            case 16: run_512(nw_one_avx512<1>); break;
            case 32: run_512(nw_one_avx512<2>); break;
            case 48: run_512(nw_one_avx512<3>); break;
            case 64: run_512(nw_one_avx512<4>); break;
            case 128: run_512(nw_one_avx512<8>); break;
            default: run_all(nw_one<0>); break;
        }
#else
        switch (W) {
            case 16: run_all(nw_one<16>); break;
            case 32: run_all(nw_one<32>); break;
            case 48: run_all(nw_one<48>); break;
            case 64: run_all(nw_one<64>); break;
            case 128: run_all(nw_one<128>); break;
            default: run_all(nw_one<0>); break;
        }
#endif
    };
    for (int t = 0; t < nt; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Batched projection into graph coordinates + per-column scoring.
// Native equivalent of models/alignment.py:project_and_score_batch (itself the
// vectorised port of processBAM.cpp scoreOneAlignment + the seed-chain
// projection).  Two passes: count columns per job, then fill column arrays.
// Column semantics per op (op,read_pos,window_ref_pos):
//   M/D ops first emit `gap` all-gap columns for skipped graph levels
//   (level jump within the same job), then the op column; I ops emit one
//   column with level -1.  Scoring per column: both-gap 0, read-only
//   log_ins, graph-only log_del, match log_match_tab[q], mismatch
//   log_mismatch_tab[q].
// ---------------------------------------------------------------------------
static const uint8_t PRJ_GAP = '_';

// ---------------------------------------------------------------------------
// rANS 4x8 decode (CRAM 3.0 block method 4; spec §13).  Mirrors
// hla_la_tpu/io/rans.py exactly — see there for the format notes.
namespace rans4x8 {
static const int TF_SHIFT = 12;
static const uint32_t TOTFREQ = 1u << TF_SHIFT;
static const uint32_t RANS_L = 1u << 23;

struct Reader {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;
    uint8_t u8() { if (p >= end) { ok = false; return 0; } return *p++; }
    uint32_t uint7() {
        uint32_t b = u8();
        if (b < 128) return b;
        return ((b & 0x7F) << 8) | u8();
    }
};

// symbol-RLE frequency table (shared by order-0 and each order-1 row)
static bool read_freqs(Reader& r, uint32_t* F /*[256] zeroed*/) {
    int j = r.u8();
    int rle = 0;
    while (r.ok) {
        F[j] = r.uint7();
        if (rle == 0 && r.p < r.end && *r.p == j + 1) {
            j = r.u8();
            rle = r.u8();
        } else if (rle > 0) {
            rle--;
            j++;
            if (j > 255) return false;
        } else {
            j = r.u8();
            if (j == 0) break;
        }
    }
    return r.ok;
}

static bool decode_o0(Reader& r, uint8_t* out, int64_t n_out) {
    uint32_t F[256] = {0};
    if (!read_freqs(r, F)) return false;
    uint32_t C[257];
    C[0] = 0;
    for (int s = 0; s < 256; s++) C[s + 1] = C[s] + F[s];
    if (C[256] != TOTFREQ) return false;
    uint8_t sym_of[TOTFREQ];
    for (int s = 0; s < 256; s++)
        for (uint32_t k = C[s]; k < C[s + 1]; k++) sym_of[k] = (uint8_t)s;
    uint32_t R[4];
    for (int j2 = 0; j2 < 4; j2++) {
        if (r.p + 4 > r.end) return false;
        std::memcpy(&R[j2], r.p, 4);
        r.p += 4;
    }
    for (int64_t i = 0; i < n_out; i++) {
        int j2 = i & 3;
        uint32_t x = R[j2];
        uint32_t slot = x & (TOTFREQ - 1);
        uint8_t s = sym_of[slot];
        out[i] = s;
        x = F[s] * (x >> TF_SHIFT) + slot - C[s];
        while (x < RANS_L && r.p < r.end) x = (x << 8) | *r.p++;
        R[j2] = x;
    }
    return true;
}

static bool decode_o1(Reader& r, uint8_t* out, int64_t n_out) {
    // context tables with the same RLE over contexts
    std::vector<uint32_t> F(256 * 256, 0);
    std::vector<uint32_t> C(256 * 257, 0);
    std::vector<uint8_t> sym_of(256 * TOTFREQ, 0);
    std::vector<uint8_t> present(256, 0);
    int cx = r.u8();
    int rle = 0;
    while (r.ok) {
        if (!read_freqs(r, &F[cx * 256])) return false;
        present[cx] = 1;
        if (rle == 0 && r.p < r.end && *r.p == cx + 1) {
            cx = r.u8();
            rle = r.u8();
        } else if (rle > 0) {
            rle--;
            cx++;
            if (cx > 255) return false;
        } else {
            cx = r.u8();
            if (cx == 0) break;
        }
    }
    if (!r.ok) return false;
    for (int c0 = 0; c0 < 256; c0++) {
        if (!present[c0]) continue;
        uint32_t* Fr = &F[c0 * 256];
        uint32_t* Cr = &C[c0 * 257];
        Cr[0] = 0;
        for (int s = 0; s < 256; s++) Cr[s + 1] = Cr[s] + Fr[s];
        if (Cr[256] != TOTFREQ) return false;
        uint8_t* so = &sym_of[(size_t)c0 * TOTFREQ];
        for (int s = 0; s < 256; s++)
            for (uint32_t k = Cr[s]; k < Cr[s + 1]; k++) so[k] = (uint8_t)s;
    }
    uint32_t R[4];
    for (int j2 = 0; j2 < 4; j2++) {
        if (r.p + 4 > r.end) return false;
        std::memcpy(&R[j2], r.p, 4);
        r.p += 4;
    }
    int64_t q = n_out >> 2;
    int64_t lo[4] = {0, q, 2 * q, 3 * q};
    int64_t hi[4] = {q, 2 * q, 3 * q, n_out};
    uint8_t last[4] = {0, 0, 0, 0};
    int64_t max_len = 0;
    for (int j2 = 0; j2 < 4; j2++)
        if (hi[j2] - lo[j2] > max_len) max_len = hi[j2] - lo[j2];
    for (int64_t t = 0; t < max_len; t++) {
        for (int j2 = 0; j2 < 4; j2++) {
            if (t >= hi[j2] - lo[j2]) continue;
            uint32_t x = R[j2];
            uint8_t c0 = last[j2];
            uint32_t slot = x & (TOTFREQ - 1);
            uint8_t s = sym_of[(size_t)c0 * TOTFREQ + slot];
            out[lo[j2] + t] = s;
            x = F[c0 * 256 + s] * (x >> TF_SHIFT) + slot
                - C[c0 * 257 + s];
            while (x < RANS_L && r.p < r.end) x = (x << 8) | *r.p++;
            R[j2] = x;
            last[j2] = s;
        }
    }
    return true;
}
}  // namespace rans4x8

// Bulk ITF8 decode of a whole CRAM external block: writes each value and
// the byte offset where the NEXT value starts.  Returns the number of
// complete values decoded (stops at a value that would overrun).
extern "C" int64_t hla_itf8_decode_all(
    const uint8_t* buf, int64_t len,
    int64_t* out_vals, int64_t* out_ends) {
    int64_t pos = 0, n = 0;
    while (pos < len) {
        uint8_t b0 = buf[pos];
        int extra = (b0 < 0x80) ? 0 : (b0 < 0xC0) ? 1 : (b0 < 0xE0) ? 2
                    : (b0 < 0xF0) ? 3 : 4;
        if (pos + 1 + extra > len) break;
        int64_t v;
        switch (extra) {
            case 0: v = b0; break;
            case 1: v = ((int64_t)(b0 & 0x3F) << 8) | buf[pos + 1]; break;
            case 2: v = ((int64_t)(b0 & 0x1F) << 16)
                        | ((int64_t)buf[pos + 1] << 8) | buf[pos + 2];
                    break;
            case 3: v = ((int64_t)(b0 & 0x0F) << 24)
                        | ((int64_t)buf[pos + 1] << 16)
                        | ((int64_t)buf[pos + 2] << 8) | buf[pos + 3];
                    break;
            default: {
                uint32_t u = ((uint32_t)(b0 & 0x0F) << 28)
                             | ((uint32_t)buf[pos + 1] << 20)
                             | ((uint32_t)buf[pos + 2] << 12)
                             | ((uint32_t)buf[pos + 3] << 4)
                             | (buf[pos + 4] & 0x0F);
                v = (int64_t)(int32_t)u;   // sign per CRAM itf8
                break;
            }
        }
        pos += 1 + extra;
        out_vals[n] = v;
        out_ends[n] = pos;
        n++;
    }
    return n;
}

// rANS Nx16 payload decode (CRAM 3.1, io/rans_nx16.py::_decode_payload).
// The caller (Python) parses the format byte, transforms and frequency
// tables; this decodes the N-state 16-bit-renorm symbol stream.  freqs is
// [n_ctx][256] int64 (n_ctx = 1 for order 0, 256 for order 1), rows
// summing to 1<<shift (or 0 for absent contexts).  Returns 0 on success.
extern "C" int hla_ransnx16_decode(
    const uint8_t* comp, int64_t comp_len, int64_t pos,
    int64_t n_out, int64_t n_states, int order, int shift,
    const int64_t* freqs, int64_t n_ctx, uint8_t* out) {
    if (shift < 1 || shift > 16 || n_states < 1 || n_states > 64 ||
        n_ctx < 1 || n_ctx > 256 || n_out < 0 || pos < 0)
        return -1;
    const int64_t tot = (int64_t)1 << shift;
    std::vector<uint8_t> sym_tab((size_t)n_ctx * tot, 0);
    std::vector<int32_t> cums((size_t)n_ctx * 257);
    for (int64_t cx = 0; cx < n_ctx; cx++) {
        const int64_t* F = freqs + cx * 256;
        int32_t c = 0;
        int32_t* C = cums.data() + cx * 257;
        for (int s = 0; s < 256; s++) {
            if (F[s] < 0 || F[s] > tot) return -2;
            C[s] = c;
            c += (int32_t)F[s];
        }
        C[256] = c;
        if (c == 0) continue;        // absent context
        if (c != tot) return -2;     // corrupt frequency table
        uint8_t* st = sym_tab.data() + cx * tot;
        int64_t w = 0;
        for (int s = 0; s < 256; s++)
            for (int64_t r = 0; r < F[s]; r++) st[w++] = (uint8_t)s;
    }
    std::vector<uint32_t> states(n_states);
    for (int64_t j = 0; j < n_states; j++) {
        if (pos + 4 > comp_len) return -3;
        states[j] = (uint32_t)comp[pos] | ((uint32_t)comp[pos + 1] << 8)
                    | ((uint32_t)comp[pos + 2] << 16)
                    | ((uint32_t)comp[pos + 3] << 24);
        pos += 4;
    }
    const uint32_t Lb = 1u << 15;
    const uint32_t mask = (uint32_t)tot - 1;
    if (order == 0) {
        const uint8_t* st = sym_tab.data();
        const int32_t* C = cums.data();
        const int64_t* F = freqs;
        for (int64_t i = 0; i < n_out; i++) {
            int64_t j = i % n_states;
            uint32_t x = states[j];
            uint32_t slot = x & mask;
            uint8_t s = st[slot];
            out[i] = s;
            x = (uint32_t)F[s] * (x >> shift) + slot - (uint32_t)C[s];
            while (x < Lb && pos + 1 < comp_len) {
                x = (x << 16) | (uint32_t)comp[pos]
                    | ((uint32_t)comp[pos + 1] << 8);
                pos += 2;
            }
            states[j] = x;
        }
    } else {
        // order 1: state j owns fragment j of N near-equal splits;
        // decode proceeds t-major across states (matches the encoder's
        // reverse-interleaved renorm stream)
        int64_t q = n_out / n_states;
        std::vector<int64_t> lo(n_states), hi(n_states);
        std::vector<uint8_t> last(n_states, 0);
        int64_t max_len = 0;
        for (int64_t j = 0; j < n_states; j++) {
            lo[j] = j * q;
            hi[j] = (j < n_states - 1) ? (j + 1) * q : n_out;
            if (hi[j] - lo[j] > max_len) max_len = hi[j] - lo[j];
        }
        for (int64_t t = 0; t < max_len; t++) {
            for (int64_t j = 0; j < n_states; j++) {
                if (t >= hi[j] - lo[j]) continue;
                uint32_t x = states[j];
                int64_t cx = last[j];
                uint32_t slot = x & mask;
                uint8_t s = sym_tab[cx * tot + slot];
                out[lo[j] + t] = s;
                x = (uint32_t)freqs[cx * 256 + s] * (x >> shift) + slot
                    - (uint32_t)cums[cx * 257 + s];
                while (x < Lb && pos + 1 < comp_len) {
                    x = (x << 16) | (uint32_t)comp[pos]
                        | ((uint32_t)comp[pos + 1] << 8);
                    pos += 2;
                }
                states[j] = x;
                last[j] = s;
            }
        }
    }
    return 0;
}

// Full rANS4x8 block (with 9-byte header).  Returns 0 on success, writes
// n_out bytes into out (caller sizes it from the header's raw size).
extern "C" int hla_rans4x8_decode(const uint8_t* blob, int64_t len,
                                  uint8_t* out, int64_t n_out) {
    if (len < 9) return -1;
    int order = blob[0];
    uint32_t n_in;
    std::memcpy(&n_in, blob + 1, 4);
    uint32_t n_raw;
    std::memcpy(&n_raw, blob + 5, 4);
    if ((int64_t)n_raw != n_out) return -2;
    if (n_out == 0) return 0;
    if (9 + (int64_t)n_in > len) return -3;
    rans4x8::Reader r{blob + 9, blob + 9 + n_in};
    bool ok = (order == 0) ? rans4x8::decode_o0(r, out, n_out)
                           : rans4x8::decode_o1(r, out, n_out);
    return ok ? 0 : -4;
}

// ---- CRAM 3.1 adaptive range coder (io/arith.py, io/fqzcomp.py) --------
// Carry-propagating range decoder + adaptive frequency models, matching
// the Python implementations bit for bit (parity tests in
// tests/test_cram31_codecs.py).  Corrupt streams are bounded: reads past
// the buffer yield zero bytes, model scans are clamped to the alphabet,
// and every output write is bounds-checked by the caller-supplied n_out.
namespace arith31 {

struct RangeDec {
    const uint8_t* buf;
    int64_t pos, end;
    uint32_t range, code, r;
    void init(const uint8_t* b, int64_t p, int64_t e) {
        buf = b; pos = p; end = e; range = 0xFFFFFFFFu; r = 0;
        uint64_t c = 0;
        for (int i = 0; i < 5; i++)
            c = (c << 8) | (pos < end ? buf[pos++] : 0);
        code = (uint32_t)c;
    }
    inline uint32_t get_freq(uint32_t tot) {
        r = range / tot;
        uint32_t f = code / r;
        return f >= tot ? tot - 1 : f;
    }
    inline void decode(uint32_t cum, uint32_t freq) {
        code -= cum * r;
        range = r * freq;
        while (range < (1u << 24)) {
            code = (code << 8) | (pos < end ? buf[pos++] : 0);
            range <<= 8;
        }
    }
};

// STEP/MAX_TOT must match io/arith.py::SimpleModel.
static const uint32_t A_STEP = 16;
static const uint32_t A_MAX_TOT = (1u << 16) - 32;

// One adaptive model = a uint16 frequency row + running total.  The
// symbol scan is clamped to nsym-1 so corrupt streams cannot overrun.
static inline int decode_sym(RangeDec& rc, uint16_t* F, uint32_t* tot,
                             int nsym) {
    uint32_t f = rc.get_freq(*tot);
    uint32_t cum = 0;
    int s = 0;
    while (s < nsym - 1 && cum + F[s] <= f) { cum += F[s]; s++; }
    rc.decode(cum, F[s]);
    F[s] = (uint16_t)(F[s] + A_STEP);
    *tot += A_STEP;
    if (*tot > A_MAX_TOT) {
        uint32_t t = 0;
        for (int i = 0; i < nsym; i++) {
            F[i] = (uint16_t)((F[i] + 1) >> 1);
            t += F[i];
        }
        *tot = t;
    }
    return s;
}

struct ModelBank {
    std::vector<uint16_t> freq;   // n_models x nsym
    std::vector<uint32_t> tot;    // n_models
    int nsym;
    ModelBank(int64_t n_models, int ns)
        : freq((size_t)n_models * ns, 1),
          tot((size_t)n_models, (uint32_t)ns), nsym(ns) {}
    inline int decode(RangeDec& rc, int64_t m) {
        return decode_sym(rc, freq.data() + m * nsym, &tot[(size_t)m],
                          nsym);
    }
};


// Carry-propagating range encoder — the exact counterpart of
// io/arith.py::RangeEncoder (byte-identical output).
struct RangeEnc {
    uint64_t low = 0;
    uint32_t range = 0xFFFFFFFFu;
    uint32_t cache = 0;
    int64_t cache_size = 1;          // seed byte; decoder skips it
    std::vector<uint8_t> out;
    void shift_low() {
        if ((low & 0xFFFFFFFFull) < 0xFF000000ull || (low >> 32)) {
            uint32_t carry = (uint32_t)(low >> 32);
            out.push_back((uint8_t)(cache + carry));
            if (cache_size > 1)
                out.insert(out.end(), (size_t)(cache_size - 1),
                           (uint8_t)(0xFF + carry));
            cache = (uint32_t)((low >> 24) & 0xFF);
            cache_size = 0;
        }
        cache_size++;
        low = (low << 8) & 0xFFFFFFFFull;
    }
    inline void encode(uint32_t cum, uint32_t freq, uint32_t tot) {
        uint32_t r = range / tot;
        low += (uint64_t)r * cum;
        range = r * freq;
        while (range < (1u << 24)) {
            range <<= 8;
            shift_low();
        }
    }
    void finish() {
        for (int i = 0; i < 5; i++) shift_low();
    }
};

static inline void encode_sym(RangeEnc& rc, uint16_t* F, uint32_t* tot,
                              int nsym, int sym) {
    uint32_t cum = 0;
    for (int s = 0; s < sym; s++) cum += F[s];
    rc.encode(cum, F[sym], *tot);
    F[sym] = (uint16_t)(F[sym] + A_STEP);
    *tot += A_STEP;
    if (*tot > A_MAX_TOT) {
        uint32_t t = 0;
        for (int i = 0; i < nsym; i++) {
            F[i] = (uint16_t)((F[i] + 1) >> 1);
            t += F[i];
        }
        *tot = t;
    }
}

struct EncModelBank {
    std::vector<uint16_t> freq;
    std::vector<uint32_t> tot;
    int nsym;
    EncModelBank(int64_t n_models, int ns)
        : freq((size_t)n_models * ns, 1),
          tot((size_t)n_models, (uint32_t)ns), nsym(ns) {}
    inline void encode(RangeEnc& rc, int64_t m, int sym) {
        encode_sym(rc, freq.data() + m * nsym, &tot[(size_t)m], nsym, sym);
    }
};

// Fenwick-backed adaptive model for 256-symbol alphabets: the linear
// cumulative scan averages ~nsym/2 entries per symbol and dominates the
// order-1 arith decode; a binary-indexed tree finds (sym, cum, freq) in
// log2(256) = 8 steps.  SAME symbol/cum/freq results and update rule as
// decode_sym -> identical bitstream semantics (search strategy only).
struct FenModel256 {
    uint16_t tree[256];           // tree[i] covers a power-of-two block
    uint32_t tot;
    void init() {
        tot = 256;
        // freqs all 1: tree[i] = (i+1) & -(i+1) (block size)
        for (int i = 0; i < 256; i++)
            tree[i] = (uint16_t)((i + 1) & -(i + 1));
    }
    inline void add(int i, int delta) {
        for (int j = i + 1; j <= 256; j += j & -j)
            tree[j - 1] = (uint16_t)(tree[j - 1] + delta);
    }
    inline uint32_t prefix(int i) const {   // sum of freqs [0, i)
        uint32_t s = 0;
        for (int j = i; j > 0; j -= j & -j) s += tree[j - 1];
        return s;
    }
    // smallest s with prefix(s+1) > f; returns s, sets cum = prefix(s)
    inline int search(uint32_t f, uint32_t* cum) const {
        int pos = 0;
        uint32_t rem = f;
        for (int step = 128; step > 0; step >>= 1) {
            int next = pos + step;
            if (next <= 256 && tree[next - 1] <= rem) {
                rem -= tree[next - 1];
                pos = next;
            }
        }
        *cum = f - rem;
        return pos;
    }
    inline int freq_of(int s) const {
        return (int)(prefix(s + 1) - prefix(s));
    }
    inline void bump(int s, int fr) {
        add(s, (int)A_STEP);
        tot += A_STEP;
        if (tot > A_MAX_TOT) {
            // halve like decode_sym: freq -> (freq+1)>>1 per symbol
            uint16_t f[256];
            uint32_t p = 0;
            for (int i = 0; i < 256; i++) {
                uint32_t np = prefix(i + 1);
                f[i] = (uint16_t)((np - p + 1) >> 1);
                p = np;
            }
            uint32_t t = 0;
            for (int i = 0; i < 256; i++) t += f[i];
            tot = t;
            // rebuild tree in O(n): tree[i] = sum of its block
            for (int i = 0; i < 256; i++) {
                uint32_t s = 0;
                int blk = (i + 1) & -(i + 1);
                for (int k = i + 1 - blk; k <= i; k++) s += f[k];
                tree[i] = (uint16_t)s;
            }
        }
        (void)fr;
    }
    inline int decode(RangeDec& rc) {
        uint32_t f = rc.get_freq(tot);
        if (f >= tot) f = tot - 1;
        uint32_t cum;
        int s = search(f, &cum);
        if (s > 255) s = 255;
        int fr = freq_of(s);
        rc.decode(cum, (uint32_t)fr);
        bump(s, fr);
        return s;
    }
    inline void encode(RangeEnc& rc, int s) {
        uint32_t cum = prefix(s);
        int fr = freq_of(s);
        rc.encode(cum, (uint32_t)fr, tot);
        bump(s, fr);
    }
};

}  // namespace arith31

// arith payload encode (io/arith.py::_encode_payload), byte-identical to
// the Python encoder.  Caller provides `out` sized >= 3*n + 64; returns
// the number of bytes written (or -1 on bad args).
extern "C" int64_t hla_arith_encode(const uint8_t* data, int64_t n,
                                    int order1, int rle, uint8_t* out,
                                    int64_t out_cap) {
    if (n < 0 || out_cap < 16) return -1;
    arith31::RangeEnc rc;
    rc.out.reserve((size_t)(n / 2 + 64));
    std::vector<arith31::FenModel256> byte_models(order1 ? 256 : 1);
    for (auto& m : byte_models) m.init();
    if (!rle) {
        int last = 0;
        for (int64_t i = 0; i < n; i++) {
            int b = data[i];
            byte_models[order1 ? last : 0].encode(rc, b);
            if (order1) last = b;
        }
    } else {
        std::vector<arith31::FenModel256> run_models(256);
        for (auto& m : run_models) m.init();
        arith31::FenModel256 cont_model;
        cont_model.init();
        int64_t i = 0;
        int last = 0;
        while (i < n) {
            int b = data[i];
            int64_t run = 1;
            while (i + run < n && data[i + run] == b) run++;
            byte_models[order1 ? last : 0].encode(rc, b);
            if (order1) last = b;
            int64_t rem = run - 1;
            int chunk = (int)(rem < 255 ? rem : 255);
            run_models[b].encode(rc, chunk);
            rem -= chunk;
            while (chunk == 255) {
                chunk = (int)(rem < 255 ? rem : 255);
                cont_model.encode(rc, chunk);
                rem -= chunk;
            }
            i += run;
        }
    }
    rc.finish();
    if ((int64_t)rc.out.size() > out_cap) return -2;
    std::memcpy(out, rc.out.data(), rc.out.size());
    return (int64_t)rc.out.size();
}

// fqzcomp coded-stream encode (io/fqzcomp.py::compress after the header),
// byte-identical to the Python encoder.  codes: the per-base model symbols
// (qmap-inverted quality bytes); lens/sels/revs/dups are per record.
// pm layout as in hla_fqz_decode.  Returns bytes written or <0 on error.
extern "C" int64_t hla_fqz_encode(
    const uint8_t* codes, int64_t n, const int64_t* lens, int64_t n_rec,
    const uint8_t* sels, const uint8_t* revs, const uint8_t* dups,
    int nparam, int gflags, const int32_t* pm, const int32_t* qtab,
    const int32_t* ptab, const int32_t* dtab, const int32_t* stab,
    uint8_t* out, int64_t out_cap) {
    const int GF_HAVE_STAB = 2, GF_DO_REV = 4;
    const int PF_DO_DEDUP = 2, PF_DO_LEN = 4, PF_DO_SEL = 8,
              PF_HAVE_PTAB = 32, PF_HAVE_DTAB = 64;
    if (n < 0 || n_rec < 0 || nparam < 1 || nparam > 256) return -1;
    int64_t model_bytes = 0;
    for (int p = 0; p < nparam; p++) {
        int max_sym = pm[p * 9 + 2];
        if (max_sym < 1 || max_sym > 256) return -1;
        model_bytes += 65536LL * max_sym * 2;
    }
    if (model_bytes > (64LL << 20)) return -1;
    arith31::RangeEnc rc;
    rc.out.reserve((size_t)(n / 3 + 64));
    std::vector<std::unique_ptr<arith31::EncModelBank>> qual;
    for (int p = 0; p < nparam; p++)
        qual.emplace_back(new arith31::EncModelBank(65536, pm[p * 9 + 2]));
    arith31::EncModelBank len_models(4, 256);
    arith31::EncModelBank sel_model(1, 256);
    arith31::EncModelBank rev_model(1, 2);
    arith31::EncModelBank dup_model(1, 2);
    const int32_t pf0 = pm[1];
    int64_t off = 0;
    bool first = true;
    for (int64_t ri = 0; ri < n_rec; ri++) {
        int64_t rec_len = lens[ri];
        if (rec_len <= 0 || off + rec_len > n) return -2;
        if (first || (pf0 & PF_DO_LEN)) {
            for (int b = 0; b < 4; b++)
                len_models.encode(rc, b,
                                  (int)((rec_len >> (8 * b)) & 0xFF));
        } else if (rec_len != lens[0]) {
            return -3;               // varying lengths need DO_LEN
        }
        first = false;
        int sel = sels ? sels[ri] : 0;
        if (pf0 & PF_DO_SEL) sel_model.encode(rc, 0, sel);
        int pset = (gflags & GF_HAVE_STAB) ? (int)stab[sel] : 0;
        if (pset < 0 || pset >= nparam) return -4;
        const int32_t* P = pm + pset * 9;
        const int32_t context = P[0], pflags = P[1];
        const int32_t qbits = P[3], qshift = P[4], qloc = P[5],
                      sloc = P[6], ploc = P[7], dloc = P[8];
        const uint32_t qmask = (1u << qbits) - 1;
        const int32_t* QT = qtab + pset * 256;
        const int32_t* PT = ptab + pset * 1024;
        const int32_t* DT = dtab + pset * 256;
        if (gflags & GF_DO_REV)
            rev_model.encode(rc, 0, revs ? revs[ri] : 0);
        if (pflags & PF_DO_DEDUP) {
            int dup = dups ? dups[ri] : 0;
            dup_model.encode(rc, 0, dup);
            if (dup) { off += rec_len; continue; }
        }
        uint32_t qctx = 0;
        int64_t p_rem = rec_len;
        int64_t delta = 0;
        int prevq = 0;
        uint32_t ctx = (uint32_t)context & 0xFFFF;
        const int32_t max_sym = P[2];
        arith31::EncModelBank& QB = *qual[pset];
        for (int64_t k = 0; k < rec_len; k++) {
            int q = codes[off + k];
            if (q >= max_sym) return -7;   // unencodable symbol
            QB.encode(rc, ctx, q);
            qctx = ((qctx << qshift) + (uint32_t)QT[q]) & qmask;
            uint32_t c = (uint32_t)context + (qctx << qloc);
            if (pflags & PF_HAVE_PTAB)
                c += (uint32_t)PT[p_rem < 1023 ? p_rem : 1023] << ploc;
            if (pflags & PF_HAVE_DTAB) {
                c += (uint32_t)DT[delta < 255 ? delta : 255] << dloc;
                delta += (prevq != q);
                prevq = q;
            }
            if (pflags & PF_DO_SEL) c += (uint32_t)sel << sloc;
            p_rem--;
            ctx = c & 0xFFFF;
        }
        off += rec_len;
    }
    if (off != n) return -5;
    rc.finish();
    if ((int64_t)rc.out.size() > out_cap) return -6;
    std::memcpy(out, rc.out.data(), rc.out.size());
    return (int64_t)rc.out.size();
}

// rANS Nx16 payload encode (io/rans_nx16.py::_encode_payload),
// byte-identical to the Python encoder.  freqs/cums are [n_ctx][256] /
// [n_ctx][257] int64 rows (n_ctx = 1 order-0, 256 order-1); ctx is the
// per-position context row (order 1) or null.  Returns bytes written.
extern "C" int64_t hla_ransnx16_encode(
    const uint8_t* arr, int64_t n, const int64_t* freqs,
    const int64_t* cums, int64_t n_states, const uint8_t* ctx, int shift,
    uint8_t* out, int64_t out_cap) {
    if (n < 0 || n_states < 1 || n_states > 64 || shift < 1 || shift > 16)
        return -1;
    if (out_cap < 2 * n + 16 * n_states + 64) return -1;
    const uint32_t Lb = 1u << 15;
    std::vector<uint32_t> states(n_states, Lb);
    std::vector<uint8_t> rev16;                 // renorm words, reversed
    rev16.reserve((size_t)n / 2 + 16);
    // (position, state, context) visit order of the DECODER; the encoder
    // pushes symbols in exactly the reverse order
    auto push = [&](int64_t i, int64_t j, int64_t cx) {
        int s = arr[i];
        uint32_t f = (uint32_t)freqs[cx * 256 + s];
        uint32_t c = (uint32_t)cums[cx * 257 + s];
        if (f == 0) return false;               // symbol outside the table
        uint32_t x = states[j];
        uint32_t x_max = ((Lb >> shift) << 16) * f;
        while (x >= x_max) {
            rev16.push_back((uint8_t)(x & 0xFF));
            rev16.push_back((uint8_t)((x >> 8) & 0xFF));
            x >>= 16;
        }
        states[j] = ((x / f) << shift) + (x % f) + c;
        return true;
    };
    if (ctx == nullptr) {
        for (int64_t i = n - 1; i >= 0; i--)
            if (!push(i, i % n_states, 0)) return -2;
    } else {
        int64_t q = n / n_states;
        std::vector<int64_t> lo(n_states), hi(n_states);
        int64_t max_len = 0;
        for (int64_t j = 0; j < n_states; j++) {
            lo[j] = j * q;
            hi[j] = (j < n_states - 1) ? (j + 1) * q : n;
            if (hi[j] - lo[j] > max_len) max_len = hi[j] - lo[j];
        }
        for (int64_t t = max_len - 1; t >= 0; t--)
            for (int64_t j = n_states - 1; j >= 0; j--)
                if (t < hi[j] - lo[j])
                    if (!push(lo[j] + t, j, ctx[lo[j] + t])) return -2;
    }
    int64_t w = 0;
    for (int64_t j = 0; j < n_states; j++) {
        uint32_t x = states[j];
        out[w++] = (uint8_t)(x & 0xFF);
        out[w++] = (uint8_t)((x >> 8) & 0xFF);
        out[w++] = (uint8_t)((x >> 16) & 0xFF);
        out[w++] = (uint8_t)((x >> 24) & 0xFF);
    }
    // rev16 holds 16-bit words in push order; emit them wordwise reversed
    for (int64_t k = (int64_t)rev16.size() - 2; k >= 0; k -= 2) {
        out[w++] = rev16[k];
        out[w++] = rev16[k + 1];
    }
    return w;
}

// arith payload decode (io/arith.py::_decode_payload): order 0/1 byte
// models, optional RLE (per-symbol run models + shared continuation
// model, base-255 chunks).  Returns 0 on success.
extern "C" int hla_arith_decode(const uint8_t* blob, int64_t len,
                                int64_t pos, uint8_t* out, int64_t n_out,
                                int order1, int rle) {
    if (pos < 0 || pos > len || n_out < 0) return -1;
    arith31::RangeDec rc;
    rc.init(blob, pos, len);
    std::vector<arith31::FenModel256> byte_models(order1 ? 256 : 1);
    for (auto& m : byte_models) m.init();
    if (!rle) {
        int last = 0;
        for (int64_t i = 0; i < n_out; i++) {
            int b = byte_models[order1 ? last : 0].decode(rc);
            out[i] = (uint8_t)b;
            if (order1) last = b;
        }
        return 0;
    }
    std::vector<arith31::FenModel256> run_models(256);
    for (auto& m : run_models) m.init();
    arith31::FenModel256 cont_model;
    cont_model.init();
    int64_t i = 0;
    int last = 0;
    while (i < n_out) {
        int b = byte_models[order1 ? last : 0].decode(rc);
        if (order1) last = b;
        int chunk = run_models[b].decode(rc);
        int64_t run = 1 + chunk;
        while (chunk == 255) {
            chunk = cont_model.decode(rc);
            run += chunk;
        }
        if (run > n_out - i) return -2;   // corrupt: run overflows output
        std::memset(out + i, b, (size_t)run);
        i += run;
    }
    return 0;
}

// fqzcomp coded-stream decode (io/fqzcomp.py::uncompress after the
// parameter block).  The Python caller parses the header and passes the
// flattened tables; this runs the per-record loop (lengths, selectors,
// reverse flags, dedup, per-base context-modelled qualities).  pm is
// nparam x 9 int32: context,pflags,max_sym,qbits,qshift,qloc,sloc,ploc,
// dloc; qmap/qtab/dtab are nparam x 256, ptab nparam x 1024, stab 256.
extern "C" int hla_fqz_decode(
    const uint8_t* blob, int64_t len, int64_t pos, uint8_t* out,
    int64_t n_out, int nparam, int gflags, const int32_t* pm,
    const int32_t* qmap, const int32_t* qtab, const int32_t* ptab,
    const int32_t* dtab, const int32_t* stab) {
    const int GF_HAVE_STAB = 2, GF_DO_REV = 4;
    const int PF_DO_DEDUP = 2, PF_DO_LEN = 4, PF_DO_SEL = 8,
              PF_HAVE_QMAP = 16, PF_HAVE_PTAB = 32, PF_HAVE_DTAB = 64;
    if (pos < 0 || pos > len || n_out < 0 || nparam < 1 || nparam > 256)
        return -1;
    int64_t model_bytes = 0;
    for (int p = 0; p < nparam; p++) {
        int max_sym = pm[p * 9 + 2];
        if (max_sym < 1 || max_sym > 256) return -1;
        model_bytes += 65536LL * max_sym * 2;
    }
    // A crafted multi-param header must not drive a multi-GB eager
    // allocation (the Python fallback allocates contexts lazily); real
    // quality alphabets are ~1 pset x <=64 syms = 8 MB.
    if (model_bytes > (64LL << 20)) return -1;
    arith31::RangeDec rc;
    rc.init(blob, pos, len);
    // per-pset quality model banks over the full 16-bit context space
    std::vector<std::unique_ptr<arith31::ModelBank>> qual;
    for (int p = 0; p < nparam; p++)
        qual.emplace_back(new arith31::ModelBank(65536, pm[p * 9 + 2]));
    arith31::ModelBank len_models(4, 256);
    arith31::ModelBank sel_model(1, 256);
    arith31::ModelBank rev_model(1, 2);
    arith31::ModelBank dup_model(1, 2);
    std::vector<std::pair<int64_t, int64_t>> rev_spans;
    const int32_t pf0 = pm[1];
    int64_t off = 0;
    bool first = true;
    int64_t rec_len = 0;
    int64_t prev_lo = -1, prev_hi = -1;
    while (off < n_out) {
        if (first || (pf0 & PF_DO_LEN)) {
            int64_t rl = 0;
            for (int b = 0; b < 4; b++)
                rl |= (int64_t)len_models.decode(rc, b) << (8 * b);
            rec_len = rl;
        }
        first = false;
        if (rec_len <= 0 || off + rec_len > n_out) return -2;
        int sel = (pf0 & PF_DO_SEL) ? sel_model.decode(rc, 0) : 0;
        int pset = (gflags & GF_HAVE_STAB) ? (int)stab[sel] : 0;
        if (pset < 0 || pset >= nparam) return -3;
        const int32_t* P = pm + pset * 9;
        const int32_t context = P[0], pflags = P[1];
        const int32_t qbits = P[3], qshift = P[4], qloc = P[5],
                      sloc = P[6], ploc = P[7], dloc = P[8];
        const uint32_t qmask = (1u << qbits) - 1;
        const int32_t* QM = qmap + pset * 256;
        const int32_t* QT = qtab + pset * 256;
        const int32_t* PT = ptab + pset * 1024;
        const int32_t* DT = dtab + pset * 256;
        int rv = (gflags & GF_DO_REV) ? rev_model.decode(rc, 0) : 0;
        if (pflags & PF_DO_DEDUP) {
            if (dup_model.decode(rc, 0)) {
                if (prev_lo < 0 || prev_hi - prev_lo != rec_len)
                    return -4;
                std::memmove(out + off, out + prev_lo, (size_t)rec_len);
                if (rv) rev_spans.emplace_back(off, off + rec_len);
                prev_lo = off; prev_hi = off + rec_len;
                off += rec_len;
                continue;
            }
        }
        uint32_t qctx = 0;
        int64_t p_rem = rec_len;
        int64_t delta = 0;
        int prevq = 0;
        uint32_t ctx = (uint32_t)context & 0xFFFF;
        arith31::ModelBank& QB = *qual[pset];
        for (int64_t k = 0; k < rec_len; k++) {
            int q = QB.decode(rc, ctx);
            out[off + k] = (uint8_t)((pflags & PF_HAVE_QMAP) ? QM[q] : q);
            // context update — io/fqzcomp.py::_update_ctx
            qctx = ((qctx << qshift) + (uint32_t)QT[q]) & qmask;
            uint32_t c = (uint32_t)context + (qctx << qloc);
            if (pflags & PF_HAVE_PTAB)
                c += (uint32_t)PT[p_rem < 1023 ? p_rem : 1023] << ploc;
            if (pflags & PF_HAVE_DTAB) {
                c += (uint32_t)DT[delta < 255 ? delta : 255] << dloc;
                delta += (prevq != q);
                prevq = q;
            }
            if (pflags & PF_DO_SEL) c += (uint32_t)sel << sloc;
            p_rem--;
            ctx = c & 0xFFFF;
        }
        if (rv) rev_spans.emplace_back(off, off + rec_len);
        prev_lo = off; prev_hi = off + rec_len;
        off += rec_len;
    }
    for (auto& sp : rev_spans) {
        uint8_t* a = out + sp.first;
        uint8_t* b = out + sp.second - 1;
        while (a < b) { uint8_t t = *a; *a++ = *b; *b-- = t; }
    }
    return 0;
}

// Rolling k-mer encode: out[i] = 2-bit code of seq[i..i+k), valid[i] = 0
// when any base is non-ACGT.  One pass instead of numpy's k passes.
// canonical != 0: out[i] = min(code, revcomp_code) — the typer's canonical
// 31-mer form (kMer_canonical_representation, HLATyper.cpp:4211-4256).
extern "C" void hla_encode_kmers_c(
    const uint8_t* seq, int64_t n, int64_t k,
    uint64_t* out, uint8_t* valid, int n_threads, int canonical) {
    int64_t n_out = n - k + 1;
    if (n_out <= 0) return;
    static uint8_t code[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; i++) code[i] = 255;
        code['A'] = code['a'] = 0; code['C'] = code['c'] = 1;
        code['G'] = code['g'] = 2; code['T'] = code['t'] = 3;
        init = true;
    }
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int rc_shift = 2 * (k - 1);
    int nt = n_threads > 0 ? n_threads : 1;
    int64_t chunk = (n_out + nt - 1) / nt;
    auto work = [&](int t) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < n_out ? lo + chunk : n_out;
        if (lo >= hi) return;
        uint64_t cur = 0, rc = 0;
        int bad = 0;               // # invalid bases in current window
        // warm the window [lo, lo+k)
        for (int64_t i = lo; i < lo + k - 1; i++) {
            uint8_t c = code[seq[i]];
            uint8_t cc = c == 255 ? 0 : c;
            cur = (cur << 2) | cc;
            rc = (rc >> 2) | ((uint64_t)(3 - cc) << rc_shift);
            if (c == 255) bad++;
        }
        for (int64_t i = lo; i < hi; i++) {
            uint8_t c = code[seq[i + k - 1]];
            uint8_t cc = c == 255 ? 0 : c;
            cur = ((cur << 2) | cc) & mask;
            rc = (rc >> 2) | ((uint64_t)(3 - cc) << rc_shift);
            if (c == 255) bad++;
            out[i] = canonical ? (cur < rc ? cur : rc) : cur;
            valid[i] = bad == 0;
            uint8_t c0 = code[seq[i]];
            if (c0 == 255) bad--;
        }
    };
    if (nt == 1) { work(0); return; }
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
}

// back-compat entry without the canonical flag
extern "C" void hla_encode_kmers(
    const uint8_t* seq, int64_t n, int64_t k,
    uint64_t* out, uint8_t* valid, int n_threads) {
    hla_encode_kmers_c(seq, n, k, out, valid, n_threads, 0);
}

// Gather encoded reference windows for a job batch: out[i] =
// enc_cat[hap_offsets[job_seq[i]] + win_start[i] .. +w], clamped to the
// haplotype's length; out-of-range columns keep the padding code 4.
// Replaces a ~40MB-of-temporaries numpy gather in _jobs_to_alignments.
extern "C" void hla_gather_windows(
    const uint8_t* enc_cat, const int64_t* hap_offsets,
    const int64_t* hap_lens, const int64_t* job_seq,
    const int64_t* win_start, int64_t nb, int64_t w,
    uint8_t* out, int n_threads) {
    int nt = n_threads > 0 ? n_threads : 1;
    auto work = [&](int t) {
        for (int64_t i = t; i < nb; i += nt) {
            uint8_t* row = out + i * w;
            std::memset(row, 4, (size_t)w);
            int64_t s = job_seq[i];
            int64_t ws = win_start[i];
            int64_t lo = ws < 0 ? 0 : ws;
            int64_t hi = ws + w;
            if (hi > hap_lens[s]) hi = hap_lens[s];
            if (hi <= lo) continue;
            std::memcpy(row + (lo - ws), enc_cat + hap_offsets[s] + lo,
                        (size_t)(hi - lo));
        }
    };
    if (nt == 1) { work(0); return; }
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
}

extern "C" int64_t hla_project_count(
    const int32_t* ops, const int64_t* n_ops,
    const int64_t* job_seq, const int64_t* window_start,
    const int64_t* hap_levels_cat, const int64_t* hap_offsets,
    const int64_t* hap_lens,
    int64_t B, int64_t max_ops,
    int64_t* col_counts, uint8_t* bad) {
    int64_t total = 0;
    for (int64_t b = 0; b < B; b++) {
        const int32_t* jo = ops + b * max_ops * 3;
        int64_t n = n_ops[b];
        int64_t seq = job_seq[b], ws = window_start[b];
        int64_t off = hap_offsets[seq], hl = hap_lens[seq];
        int64_t cnt = 0, prev_lv = -1;
        bool have_prev = false, is_bad = (n == 0);
        for (int64_t k = 0; k < n && !is_bad; k++) {
            int32_t o = jo[3 * k];
            if (o != 1) {  // M or D consume the haplotype
                int64_t p = ws + (int64_t)jo[3 * k + 2];
                if (p < 0 || p >= hl) { is_bad = true; break; }
                int64_t lv = hap_levels_cat[off + p];
                if (have_prev && lv - prev_lv > 1) cnt += lv - prev_lv - 1;
                prev_lv = lv; have_prev = true;
            }
            cnt++;
        }
        bad[b] = is_bad ? 1 : 0;
        col_counts[b] = is_bad ? 0 : cnt;
        total += col_counts[b];
    }
    return total;
}

extern "C" void hla_project_fill(
    const int32_t* ops, const int64_t* n_ops,
    const int64_t* job_seq, const int64_t* window_start,
    const uint8_t* reads_ascii, const uint8_t* quals_ascii, int64_t Lr,
    const uint8_t* hap_codes_cat, const int64_t* hap_levels_cat,
    const int64_t* hap_offsets,
    int64_t B, int64_t max_ops,
    const int64_t* col_starts, const uint8_t* bad, const uint8_t* rev,
    const double* log_match_tab, const double* log_mismatch_tab,
    double log_ins, double log_del,
    int64_t* levels, uint8_t* graph_c, uint8_t* seq_c, uint8_t* qual_c,
    int64_t* pos_keys, double* ll, int64_t* first_lv, int64_t* last_lv,
    int64_t* lv2,    // [B*4]: first, second, penultimate, last valid level
    int n_threads) {
    int nt = n_threads > 0 ? n_threads : 1;
    std::vector<std::thread> threads;
    auto work = [=](int t) {
        for (int64_t b = t; b < B; b += nt) {
            ll[b] = 0.0; first_lv[b] = -1; last_lv[b] = -1;
            if (bad[b]) continue;
            const int32_t* jo = ops + b * max_ops * 3;
            const uint8_t* rd = reads_ascii + b * Lr;
            const uint8_t* qd = quals_ascii + b * Lr;
            int64_t n = n_ops[b];
            int64_t off = hap_offsets[job_seq[b]], ws = window_start[b];
            int64_t pos = col_starts[b], prev_lv = -1;
            bool have_prev = false;
            double acc = 0.0;
            for (int64_t k = 0; k < n; k++) {
                int32_t o = jo[3 * k];
                int64_t rp = jo[3 * k + 1];
                if (o == 1) {  // insertion: read char vs graph gap
                    levels[pos] = -1;
                    graph_c[pos] = PRJ_GAP;
                    seq_c[pos] = rd[rp];
                    qual_c[pos] = qd[rp];
                    acc += log_ins;
                    pos++;
                    continue;
                }
                int64_t g = off + ws + (int64_t)jo[3 * k + 2];
                int64_t lv = hap_levels_cat[g];
                if (have_prev && lv - prev_lv > 1) {
                    for (int64_t lvg = prev_lv + 1; lvg < lv; lvg++) {
                        levels[pos] = lvg;
                        graph_c[pos] = PRJ_GAP; seq_c[pos] = PRJ_GAP;
                        qual_c[pos] = 0;
                        pos++;
                    }
                }
                prev_lv = lv; have_prev = true;
                if (first_lv[b] < 0) first_lv[b] = lv;
                last_lv[b] = lv;
                uint8_t gc = hap_codes_cat[g];
                levels[pos] = lv;
                graph_c[pos] = gc;
                if (o == 0) {  // M
                    uint8_t sc = rd[rp], q = qd[rp];
                    seq_c[pos] = sc; qual_c[pos] = q;
                    if (gc == PRJ_GAP) acc += (sc == PRJ_GAP) ? 0.0 : log_ins;
                    else if (sc == PRJ_GAP) acc += log_del;
                    else acc += (sc == gc) ? log_match_tab[q]
                                           : log_mismatch_tab[q];
                } else {       // D: graph char vs read gap
                    seq_c[pos] = PRJ_GAP; qual_c[pos] = 0;
                    if (gc != PRJ_GAP) acc += log_del;
                }
                pos++;
            }
            ll[b] = acc;
            // position-identity keys (aligner._position_keys formula:
            // ((level+2)<<28)|((read_idx+2)<<10)|(graph_char<<1)|reverse)
            int64_t start = col_starts[b];
            int64_t rv = rev[b] ? 1 : 0;
            int64_t n_b = 0;
            for (int64_t cix = start; cix < pos; cix++)
                if (seq_c[cix] != PRJ_GAP) n_b++;
            int64_t running = 0;
            int64_t f1 = -1, f2 = -1, l1 = -1, l2x = -1;
            for (int64_t cix = start; cix < pos; cix++) {
                int64_t lvv = levels[cix];
                if (lvv >= 0) {
                    if (f1 < 0) f1 = lvv; else if (f2 < 0) f2 = lvv;
                    l2x = l1; l1 = lvv;
                }
                int64_t idx = -1;
                if (seq_c[cix] != PRJ_GAP) {
                    idx = rv ? (n_b - running - 1) : running;
                    running++;
                }
                pos_keys[cix] = ((lvv + 2) << 28)
                                | ((idx + 2) << 10)
                                | ((int64_t)graph_c[cix] << 1) | rv;
            }
            lv2[4 * b] = f1; lv2[4 * b + 1] = f2;
            lv2[4 * b + 2] = l2x; lv2[4 * b + 3] = l1;
        }
    };
    for (int t = 0; t < nt; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Seed-candidate selection (mapping/seeder.py:_select, the protoSeeds
// top-candidate rule of processBAM.cpp:521-701): stable-sort all chain groups
// by (read, -n_kmers, -span, insertion order), then per read greedily keep up
// to max_cands, skipping groups within `slack2` of an already-kept group on
// the same (haplotype, strand).  Outputs selected group indices per read.
// ---------------------------------------------------------------------------
#include <algorithm>

extern "C" void hla_seed_select(
    const int64_t* read_of, const int64_t* seq_idx, const uint8_t* reverse,
    const int64_t* ref_start, const int64_t* n_kmers, const int64_t* span,
    int64_t n_groups, int64_t n_reads, int64_t max_cands, int64_t slack2,
    int64_t* out_idx,      // [n_reads * max_cands] selected group indices
    int64_t* out_counts) { // [n_reads]
    std::vector<int64_t> order(n_groups);
    for (int64_t i = 0; i < n_groups; i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
        if (read_of[a] != read_of[b]) return read_of[a] < read_of[b];
        if (n_kmers[a] != n_kmers[b]) return n_kmers[a] > n_kmers[b];
        return span[a] > span[b];
    });
    for (int64_t r = 0; r < n_reads; r++) out_counts[r] = 0;
    int64_t i = 0;
    while (i < n_groups) {
        int64_t r = read_of[order[i]];
        int64_t j = i;
        while (j < n_groups && read_of[order[j]] == r) j++;
        int64_t* kept = out_idx + r * max_cands;
        int64_t nk = 0;
        for (int64_t t = i; t < j && nk < max_cands; t++) {
            int64_t g = order[t];
            bool dup = false;
            for (int64_t u = 0; u < nk; u++) {
                int64_t kg = kept[u];
                if (seq_idx[kg] == seq_idx[g] && reverse[kg] == reverse[g]
                    && std::llabs(ref_start[kg] - ref_start[g]) <= slack2) {
                    dup = true; break;
                }
            }
            if (!dup) kept[nk++] = g;
        }
        out_counts[r] = nk;
        i = j;
    }
}

// ---------------------------------------------------------------------------
// Full seed chaining: query k-mer codes against the sorted index, expand
// hits, and group them into diagonal-consistent chains with per-group stats.
// Native equivalent of KmerIndex.query_codes + the grouping half of
// Seeder.candidates_batch (kmer_index.py:86-101, seeder.py:86-125); the
// protoSeeds step of processBAM.cpp:521-701.
// Exact semantics: k-mers with more than max_occ index hits are skipped
// entirely; groups are (read, seq, floor(diag/slack)); per group stats are
// mid-diag (element at (start+end)/2 in diag order), distinct read k-mer
// start count, and rp span + k; a group is kept when its size >= min_chain
// if the read has >= min_chain hits on this strand, else >= 1.
// Outputs are malloc'd arrays (caller frees with hla_free).
// ---------------------------------------------------------------------------
struct SeedHit { int32_t read, seq, diag, rp, qdiag; };

extern "C" int64_t hla_seed_chain(
    const uint8_t* seq, int64_t total,   // concatenated reads, '\0' separated
    const uint64_t* sorted_codes, const int64_t* sorted_pos, int64_t M,
    const int64_t* bstart_ext, int64_t pbits_ext,  // cached prefix table or 0
    int64_t max_occ,
    const int64_t* seq_offsets, int64_t S,
    const int64_t* slot_offsets, int64_t R,      // concat offsets, [R+1]
    const int64_t* slot_to_read,                 // [R] or NULL (identity)
    int64_t n_reads, int64_t slack, int64_t min_chain, int64_t k,
    int64_t stride,                              // query every stride-th pos
    int64_t** out_read, int64_t** out_seq, int64_t** out_start,
    int64_t** out_nk, int64_t** out_span) {
    if (stride < 1) stride = 1;
    std::vector<SeedHit> hits;
    hits.reserve(1 << 16);
    std::vector<int64_t> read_hits(n_reads, 0);
    auto fdiv0 = [](int64_t a, int64_t b) {
        int64_t q = a / b; if ((a % b != 0) && ((a < 0) != (b < 0))) q--;
        return q;
    };
    // prefix-bucket table over the top bits of the 2k-bit codes: narrows
    // every query to a handful of index entries.  Callers pass a cached
    // table (bstart_ext/pbits_ext); otherwise a 16-bit one is built here.
    int pbits;
    const int64_t* bstart;
    std::vector<int64_t> bstart_own;
    if (bstart_ext != nullptr) {
        pbits = (int)pbits_ext;
        bstart = bstart_ext;
    } else {
        pbits = (2 * (int)k < 16) ? 2 * (int)k : 16;
        int64_t nb0 = (int64_t)1 << pbits;
        bstart_own.resize(nb0 + 1);
        int64_t m = 0;
        int psh = 2 * (int)k - pbits;
        for (int64_t p = 0; p <= nb0; p++) {
            while (m < M && (int64_t)(sorted_codes[m] >> psh) < p) m++;
            bstart_own[p] = m;
        }
        bstart = bstart_own.data();
    }
    int pshift = 2 * (int)k - pbits;
    // rolling 2-bit encode over the concatenated reads (kmer_index.py
    // encode_kmers semantics: a k-mer is valid iff all bases are ACGT)
    uint8_t b2[256];
    for (int t = 0; t < 256; t++) b2[t] = 255;
    const char* ACGT = "ACGT";
    for (int t = 0; t < 4; t++) {
        b2[(uint8_t)ACGT[t]] = (uint8_t)t;
        b2[(uint8_t)(ACGT[t] + 32)] = (uint8_t)t;
    }
    uint64_t mask = (k * 2 >= 64) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    uint64_t code = 0;
    int64_t last_bad = -1;
    int64_t slot = 0;
    // The query loop is memory-latency-bound: bstart[] (4M entries at
    // pbits=22) and the sorted_codes bucket are random accesses that miss
    // cache on nearly every k-mer.  Batch queries and software-prefetch
    // two stages ahead (bucket table on enqueue, bucket payload on flush)
    // so the misses overlap instead of serialising.
    struct PendQ { uint64_t c; int64_t b0, b1; int32_t rd, rp; };
    constexpr int QB = 64;
    PendQ pend[QB];
    int npend = 0;
    auto flush = [&]() {
        for (int q = 0; q < npend; q++) {
            PendQ& e = pend[q];
            e.b0 = bstart[e.c >> pshift];
            e.b1 = bstart[(e.c >> pshift) + 1];
            if (e.b1 > e.b0) {
                __builtin_prefetch(sorted_codes + e.b0);
                __builtin_prefetch(sorted_pos + e.b0);
            }
        }
        for (int q = 0; q < npend; q++) {
            const PendQ& e = pend[q];
            const uint64_t* b0 = sorted_codes + e.b0;
            const uint64_t* b1 = sorted_codes + e.b1;
            const uint64_t* lo = std::lower_bound(b0, b1, e.c);
            const uint64_t* hi = std::upper_bound(lo, b1, e.c);
            int64_t cnt = hi - lo;
            if (cnt == 0 || cnt > max_occ) continue;
            for (int64_t h = lo - sorted_codes; h < hi - sorted_codes; h++) {
                int64_t gp = sorted_pos[h];
                // sequence of this global position (seq_offsets asc, [S+1])
                int64_t si = std::upper_bound(seq_offsets,
                                              seq_offsets + S + 1, gp)
                             - seq_offsets - 1;
                int32_t ref_pos = (int32_t)(gp - seq_offsets[si]);
                int32_t dg = ref_pos - e.rp;
                hits.push_back({e.rd, (int32_t)si, dg, e.rp,
                                (int32_t)fdiv0(dg, slack)});
                read_hits[e.rd]++;
            }
        }
        npend = 0;
    };
    for (int64_t j = 0; j < total; j++) {
        uint8_t cb = b2[seq[j]];
        if (cb == 255) { last_bad = j; code = (code << 2) & mask; }
        else code = ((code << 2) | cb) & mask;
        int64_t i = j - k + 1;       // k-mer start position
        if (i < 0 || last_bad >= i) continue;
        while (slot + 1 < R && i >= slot_offsets[slot + 1]) slot++;
        int64_t rd = slot_to_read ? slot_to_read[slot] : slot;
        int32_t rp = (int32_t)(i - slot_offsets[slot]);
        if (stride > 1 && (rp % stride) != 0) continue;
        __builtin_prefetch(&bstart[code >> pshift]);
        pend[npend++] = {code, 0, 0, (int32_t)rd, rp};
        if (npend == QB) flush();
    }
    flush();
    if (hits.empty()) {
        *out_read = *out_seq = *out_start = *out_nk = *out_span = nullptr;
        return 0;
    }
    // Hits are generated slot-contiguously and every read owns exactly one
    // slot per call (fwd: slot == read; rev: slot_to_read is a permutation),
    // so each read's hits form one contiguous segment already.  Sorting the
    // small per-read segments (tens of hits, cache-resident) instead of the
    // whole multi-M-hit array is ~3x cheaper and yields the same groups;
    // only the cross-read output order changes, which the downstream
    // hla_seed_select stable-sorts by read anyway (within-read order — the
    // tie-break that matters — is identical).
    int64_t n = hits.size();
    auto hit_lt = [](const SeedHit& a, const SeedHit& b) {
        if (a.seq != b.seq) return a.seq < b.seq;
        if (a.qdiag != b.qdiag) return a.qdiag < b.qdiag;
        return a.diag < b.diag;
    };
    for (int64_t seg = 0; seg < n;) {
        int64_t seg_end = seg + 1;
        while (seg_end < n && hits[seg_end].read == hits[seg].read) seg_end++;
        std::sort(hits.begin() + seg, hits.begin() + seg_end, hit_lt);
        seg = seg_end;
    }
    int64_t* g_read = (int64_t*)malloc(n * sizeof(int64_t));
    int64_t* g_seq = (int64_t*)malloc(n * sizeof(int64_t));
    int64_t* g_start = (int64_t*)malloc(n * sizeof(int64_t));
    int64_t* g_nk = (int64_t*)malloc(n * sizeof(int64_t));
    int64_t* g_span = (int64_t*)malloc(n * sizeof(int64_t));
    int64_t ng = 0;
    std::vector<int32_t> rp_buf;
    int64_t i = 0;
    while (i < n) {
        int64_t j = i + 1;
        while (j < n && hits[j].read == hits[i].read
               && hits[j].seq == hits[i].seq
               && hits[j].qdiag == hits[i].qdiag) j++;
        int64_t size = j - i;
        int64_t req = (read_hits[hits[i].read] >= min_chain) ? min_chain : 1;
        if (size >= req) {
            int32_t rp_min = hits[i].rp, rp_max = hits[i].rp;
            rp_buf.clear();
            for (int64_t t = i; t < j; t++) {
                rp_min = std::min(rp_min, hits[t].rp);
                rp_max = std::max(rp_max, hits[t].rp);
                rp_buf.push_back(hits[t].rp);
            }
            std::sort(rp_buf.begin(), rp_buf.end());
            int64_t nu = 1;
            for (size_t t = 1; t < rp_buf.size(); t++)
                if (rp_buf[t] != rp_buf[t - 1]) nu++;
            g_read[ng] = hits[i].read;
            g_seq[ng] = hits[i].seq;
            g_start[ng] = hits[(i + j) / 2].diag;
            g_nk[ng] = nu;
            g_span[ng] = (int64_t)(rp_max - rp_min) + k;
            ng++;
        }
        i = j;
    }
    *out_read = g_read; *out_seq = g_seq; *out_start = g_start;
    *out_nk = g_nk; *out_span = g_span;
    return ng;
}

// ---------------------------------------------------------------------------
// Haplotype walk: node entered at each level for the path emitting the
// haplotype (models/graph_fallback.py:walk_haplotype semantics; the
// Graph::trace role behind extendSeedChain's haplotype anchoring).
// Forward reachability pass over the level DAG, then one backward pick.
// Returns 1 on success (out_path [n_levels] filled), 0 if not a graph path.
// ---------------------------------------------------------------------------
// Walk the haplotype emissions through the graph over the level window
// [lv_lo, lv_hi] (inclusive of both level boundaries: out_path has
// lv_hi - lv_lo + 1 entries, out_path[i] = node entered at level lv_lo+i).
// The initial frontier is every node at lv_lo, so any consistent path
// through the window is found — sufficient for anchoring the graph DP
// (graph_fallback.realign uses the path only at the anchor level), and
// O(window) instead of O(whole graph) on multi-M-level PRGs.
extern "C" int hla_walk_haplotype(
    const int64_t* level_offsets, int64_t n_levels,    // [n_levels+1]
    const int64_t* out_offsets, const int32_t* out_edges,
    const int64_t* in_offsets, const int32_t* in_edges,
    const int32_t* edge_from, const int32_t* edge_to,
    const uint8_t* edge_emission,
    const uint8_t* row,            // [lv_hi - lv_lo] wanted emissions for
                                   // levels [lv_lo, lv_hi), window-local
                                   // (row[i] = emission at level lv_lo+i) —
                                   // a global row would make every walk
                                   // O(graph) to BUILD on 3M-level PRGs
    int64_t n_nodes,
    int64_t lv_lo, int64_t lv_hi,  // 0 <= lv_lo <= lv_hi <= n_levels-1
    int64_t* out_path) {           // [lv_hi - lv_lo + 1]
    std::vector<uint8_t> reach(level_offsets[lv_hi + 1] - level_offsets[lv_lo],
                               0);
    const int64_t base = level_offsets[lv_lo];
    for (int64_t n = level_offsets[lv_lo]; n < level_offsets[lv_lo + 1]; n++)
        reach[n - base] = 1;
    for (int64_t lv = lv_lo; lv < lv_hi; lv++) {
        uint8_t want = row[lv - lv_lo];
        bool any = false;
        for (int64_t n = level_offsets[lv]; n < level_offsets[lv + 1]; n++) {
            if (!reach[n - base]) continue;
            for (int64_t k = out_offsets[n]; k < out_offsets[n + 1]; k++) {
                int32_t e = out_edges[k];
                if (edge_emission[e] == want) {
                    reach[edge_to[e] - base] = 1;
                    any = true;
                }
            }
        }
        if (!any) return 0;
    }
    int64_t node = -1;
    for (int64_t n = level_offsets[lv_hi]; n < level_offsets[lv_hi + 1]; n++)
        if (reach[n - base]) { node = n; break; }
    if (node < 0) return 0;
    out_path[lv_hi - lv_lo] = node;
    for (int64_t lv = lv_hi - 1; lv >= lv_lo; lv--) {
        int64_t prev = -1;
        for (int64_t k = in_offsets[node]; k < in_offsets[node + 1]; k++) {
            int32_t e = in_edges[k];
            if (edge_emission[e] == row[lv - lv_lo]
                && reach[edge_from[e] - base]) {
                prev = edge_from[e];
                break;
            }
        }
        if (prev < 0) return 0;
        out_path[lv - lv_lo] = prev;
        node = prev;
    }
    return 1;
}

// ---------------------------------------------------------------------------
// Pair combination selection + mapping qualities.  Native port of
// models/aligner.py:_select_pair (alignOneReadPair, processBAM.cpp:3408-3540
// + assignMappingQualities, processBAM.cpp:4062-4310):
//   combos (i1, i2): LL = ll1 + ll2 + insert term; insert term = max over
//   shared-underlying-sequence distances of Normal logpdf (8-sigma penalty
//   when the pdf underflows below exp(-700) or no distance/invalid strands);
//   softmax over combos -> pair mapq, per-chain marginal mapqs, and
//   per-position confidences aggregated over identical position keys.
// Chains are globally indexed (pair i: n1[i] mate-1 chains then n2[i]
// mate-2); per-chain conf outputs share the key layout and are written for
// the selected chains only.
// ---------------------------------------------------------------------------
#include <cmath>
#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

static inline double nlogpdf(double x, double mean, double sd) {
    double z = (x - mean) / sd;
    return -0.5 * z * z - std::log(sd * std::sqrt(2.0 * M_PI));
}

extern "C" void hla_select_pairs(
    int64_t n_pairs, const int64_t* n1, const int64_t* n2,
    const double* ll, const int64_t* f_lv, const int64_t* l_lv,
    const int64_t* lv2,            // [n_chains*4] f1,f2,penult,last
    const uint8_t* rev,
    const int64_t* key_off, const int64_t* keys,   // [n_chains+1], flat
    const int64_t* tr_cat, const int64_t* tr_off, int64_t S,  // [S+1] offs
    double insert_mean, double insert_sd, double max_pen_log,
    int64_t* out_b1, int64_t* out_b2,              // selected local indices
    double* out_pair_mapq, double* out_mapq1, double* out_mapq2,
    double* out_conf) {                            // flat, keys layout
    std::vector<std::vector<std::pair<int32_t, int32_t>>> anch_end, anch_beg;
    std::vector<double> lls;
    std::vector<std::pair<int64_t, double>> kw;
    int64_t base = 0;
    for (int64_t p = 0; p < n_pairs; p++) {
        int64_t c1n = n1[p], c2n = n2[p];
        int64_t nch = c1n + c2n;
        // anchors per chain: for each sequence, position of the last (resp.
        // first) anchor level present in its translation; first priority
        // level wins (alignment.py:_anchors with scan=2)
        anch_end.assign(nch, {});
        anch_beg.assign(nch, {});
        auto build = [&](int64_t ci, bool from_end) {
            auto& out = from_end ? anch_end[ci] : anch_beg[ci];
            const int64_t* q = lv2 + (base + ci) * 4;
            int64_t pri[2];
            if (from_end) { pri[0] = q[3]; pri[1] = q[2]; }
            else { pri[0] = q[0]; pri[1] = q[1]; }
            for (int32_t s = 0; s < (int32_t)S; s++) {
                const int64_t* t0 = tr_cat + tr_off[s];
                const int64_t* t1 = tr_cat + tr_off[s + 1];
                for (int pr = 0; pr < 2; pr++) {
                    if (pri[pr] < 0) continue;
                    const int64_t* it = std::lower_bound(t0, t1, pri[pr]);
                    if (it != t1 && *it == pri[pr]) {
                        out.push_back({s, (int32_t)(it - t0)});
                        break;
                    }
                }
            }
        };
        for (int64_t ci = 0; ci < nch; ci++) { build(ci, true); build(ci, false); }
        lls.assign(c1n * c2n, 0.0);
        for (int64_t i1 = 0; i1 < c1n; i1++) {
            int64_t g1 = base + i1;
            for (int64_t i2 = 0; i2 < c2n; i2++) {
                int64_t g2 = base + c1n + i2;
                double v = ll[g1] + ll[g2];
                // strands_valid (alignerBase.cpp:213-244)
                bool sv = (f_lv[g1] != -1 && f_lv[g2] != -1
                           && rev[g1] != rev[g2]
                           && (!rev[g1] ? f_lv[g1] < f_lv[g2]
                                        : l_lv[g1] > l_lv[g2]));
                double ll_is = max_pen_log;
                if (sv) {
                    const auto* endv = &anch_end[i1];
                    const auto* begv = &anch_beg[c1n + i2];
                    if (!(f_lv[g1] < f_lv[g2])) {
                        endv = &anch_end[c1n + i2];
                        begv = &anch_beg[i1];
                    }
                    bool any = false;
                    double best = -1e300;
                    size_t a = 0, b = 0;
                    while (a < endv->size() && b < begv->size()) {
                        int32_t sa = (*endv)[a].first, sb = (*begv)[b].first;
                        if (sa < sb) a++;
                        else if (sb < sa) b++;
                        else {
                            double d = (double)((*begv)[b].second
                                                - (*endv)[a].second - 1);
                            double lp = nlogpdf(d, insert_mean, insert_sd);
                            double val = (lp < -700.0) ? max_pen_log : lp;
                            if (!any || val > best) best = val;
                            any = true;
                            a++; b++;
                        }
                    }
                    if (any) ll_is = best;
                }
                lls[i1 * c2n + i2] = v + ll_is;
            }
        }
        int64_t bestc = 0;
        for (int64_t t = 1; t < (int64_t)lls.size(); t++)
            if (lls[t] > lls[bestc]) bestc = t;
        double mx = lls[bestc], sum = 0.0;
        std::vector<double> pp(lls.size());
        for (size_t t = 0; t < lls.size(); t++) {
            pp[t] = std::exp(lls[t] - mx);
            sum += pp[t];
        }
        for (auto& x : pp) x /= sum;
        int64_t b1 = bestc / c2n, b2 = bestc % c2n;
        out_b1[p] = b1; out_b2[p] = b2;
        out_pair_mapq[p] = pp[bestc];
        double m1 = 0.0, m2 = 0.0;
        for (int64_t i1 = 0; i1 < c1n; i1++)
            for (int64_t i2 = 0; i2 < c2n; i2++) {
                if (i1 == b1) m1 += pp[i1 * c2n + i2];
                if (i2 == b2) m2 += pp[i1 * c2n + i2];
            }
        out_mapq1[p] = std::min(m1, 1.0);
        out_mapq2[p] = std::min(m2, 1.0);
        // per-position confidences per mate (assignMappingQualities,
        // processBAM.cpp:4183-4209): each chain's keys get its marginal
        // combination weight; identical keys accumulate
        for (int mate = 0; mate < 2; mate++) {
            int64_t cn = mate == 0 ? c1n : c2n;
            int64_t coff = mate == 0 ? 0 : c1n;
            int64_t bsel = mate == 0 ? b1 : b2;
            kw.clear();
            for (int64_t ci = 0; ci < cn; ci++) {
                double w = 0.0;
                for (int64_t o = 0; o < (mate == 0 ? c2n : c1n); o++)
                    w += pp[mate == 0 ? ci * c2n + o : o * c2n + ci];
                int64_t g = base + coff + ci;
                for (int64_t t = key_off[g]; t < key_off[g + 1]; t++)
                    kw.push_back({keys[t], w});
            }
            // stable: equal keys keep occurrence order, so the per-key sum
            // matches numpy's np.add.at accumulation bit-for-bit
            std::stable_sort(kw.begin(), kw.end(),
                             [](const std::pair<int64_t, double>& x,
                                const std::pair<int64_t, double>& y) {
                                 return x.first < y.first;
                             });
            // sum runs of equal keys in place
            std::vector<std::pair<int64_t, double>> uniq;
            uniq.reserve(kw.size());
            for (size_t t = 0; t < kw.size(); t++) {
                if (!uniq.empty() && uniq.back().first == kw[t].first)
                    uniq.back().second += kw[t].second;
                else uniq.push_back(kw[t]);
            }
            int64_t g = base + coff + bsel;
            for (int64_t t = key_off[g]; t < key_off[g + 1]; t++) {
                auto it = std::lower_bound(
                    uniq.begin(), uniq.end(),
                    std::make_pair(keys[t], -1e300));
                out_conf[t] = std::min(it->second, 1.0);
            }
        }
        base += nch;
    }
}

// ------------------------------------------------------- graph-space DP
// Native port of ops/graph_dp.py::extend_graph_dp (itself a faithful
// reimplementation of the reference's
// fullNeedleman_diagonal_extension_gapJumper, extensionAligner.cpp:335-1557).
// Sparse diagonal sweep over cells (level x, seqpos y, node z), three states
// D/GraphGap/SequenceGap, per-diagonal pruning, gap jumps.  Candidate
// resolution replicates the Python insertion-order / first-strict-max
// semantics exactly, so results are identical to the Python implementation.
#include <unordered_map>

namespace graphdp {
constexpr double NEG = -1e30;
constexpr int D = 0, GG = 1, SG = 2;
constexpr int GAPC = '_';
struct BTrec {
    int64_t px, py, pz;
    int32_t pst;
    int32_t em_g, em_s;      // -1 = matrix switch, -2 = gap jump
    int64_t lvl;             // emitted level (-1 insert) or jump length
};
struct Cell {
    double s[3];
    BTrec bt[3];
    bool has_bt[3];
};
struct XYZ { int64_t x, y, z; };
struct CandCell {
    int64_t x, y, z;
    double best[3];
    BTrec bt[3];
    bool has[3];
};
}  // namespace graphdp

extern "C" int64_t hla_graph_extend(
    const int64_t* level_offsets,
    const int32_t* node_level, const int32_t* node_z,
    const int32_t* edge_from, const int32_t* edge_to,
    const uint8_t* edge_emission,
    const int64_t* out_offsets, const int32_t* out_edges,
    const int64_t* in_offsets, const int32_t* in_edges,
    const int32_t* jump_from, const int32_t* jump_to,
    const int32_t* jump_len,
    const int64_t* jump_out_offsets, const int32_t* jump_out,
    const int64_t* jump_in_offsets, const int32_t* jump_in,
    int64_t n_levels, int64_t zmul,
    const uint8_t* seq, int64_t seq_len,
    int64_t start_seq, int64_t start_level, int64_t start_z,
    int positive, int64_t lim_level, int64_t lim_seq,
    double s_match, double s_mismatch, double s_open, double s_extend,
    double s_graph_gap, double diag_filter, int64_t max_noninc,
    double stop_thr,
    uint8_t* out_graph, uint8_t* out_seq_c, int64_t* out_levels,
    int64_t out_cap, double* out_score, int64_t* out_end) {
    using namespace graphdp;
    const uint64_t ymul = (uint64_t)(seq_len + 2);
    auto key_of = [&](int64_t x, int64_t y, int64_t z) -> uint64_t {
        return ((uint64_t)x * ymul + (uint64_t)(y + 1)) * (uint64_t)zmul
               + (uint64_t)z;
    };
    auto node_of = [&](int64_t lv, int64_t z) -> int64_t {
        return level_offsets[lv] + z;
    };
    auto in_bounds = [&](int64_t x, int64_t y) -> bool {
        return positive ? (x <= lim_level && y <= lim_seq)
                        : (x >= lim_level && y >= lim_seq);
    };

    std::unordered_map<uint64_t, Cell> scores;
    scores.reserve(4096);
    {
        Cell c0;
        c0.s[0] = 0.0; c0.s[1] = NEG; c0.s[2] = NEG;
        c0.has_bt[0] = c0.has_bt[1] = c0.has_bt[2] = false;
        scores.emplace(key_of(start_level, start_seq, start_z), c0);
    }
    double current_max = 0.0;
    std::vector<XYZ> maxima{{start_level, start_seq, start_z}};
    int64_t last_improve = 0;
    std::vector<XYZ> frontier_m1{{start_level, start_seq, start_z}};
    std::vector<XYZ> frontier_m2;
    const int64_t step = positive ? 1 : -1;

    std::unordered_map<uint64_t, int32_t> cand_idx;
    std::vector<CandCell> cand;
    cand_idx.reserve(4096);
    auto push = [&](int64_t x, int64_t y, int64_t z, int st, double v,
                    const BTrec& bt) {
        uint64_t k = key_of(x, y, z);
        auto ins = cand_idx.try_emplace(k, (int32_t)cand.size());
        if (ins.second) {
            CandCell cc;
            cc.x = x; cc.y = y; cc.z = z;
            cc.best[0] = cc.best[1] = cc.best[2] = NEG;
            cc.has[0] = cc.has[1] = cc.has[2] = false;
            cand.push_back(cc);
        }
        CandCell& cc = cand[ins.first->second];
        if (!cc.has[st] || v > cc.best[st]) {
            cc.best[st] = v; cc.bt[st] = bt; cc.has[st] = true;
        }
    };

    const int64_t diagonals = seq_len + n_levels;
    std::vector<XYZ> new_cells;
    for (int64_t diag = 1; diag <= diagonals; diag++) {
        if (diag - last_improve > max_noninc) break;
        cand.clear();
        cand_idx.clear();

        // from m-2 diagonal: match/mismatch
        for (const XYZ& c : frontier_m2) {
            int64_t nx = c.x + step, ny = c.y + step;
            if (!in_bounds(nx, ny)) continue;
            int s_em = positive ? seq[c.y] : seq[c.y - 1];
            double prev_d = scores[key_of(c.x, c.y, c.z)].s[D];
            if (prev_d <= NEG / 2) continue;
            int64_t node = node_of(c.x, c.z);
            int64_t lvl = positive ? nx - 1 : nx;
            if (positive) {
                for (int64_t e = out_offsets[node]; e < out_offsets[node + 1];
                     e++) {
                    int32_t eid = out_edges[e];
                    int64_t nz = node_z[edge_to[eid]];
                    int em = edge_emission[eid];
                    push(nx, ny, nz, D,
                         prev_d + (em == s_em ? s_match : s_mismatch),
                         BTrec{c.x, c.y, c.z, D, em, s_em, lvl});
                }
            } else {
                for (int64_t e = in_offsets[node]; e < in_offsets[node + 1];
                     e++) {
                    int32_t eid = in_edges[e];
                    int64_t nz = node_z[edge_from[eid]];
                    int em = edge_emission[eid];
                    push(nx, ny, nz, D,
                         prev_d + (em == s_em ? s_match : s_mismatch),
                         BTrec{c.x, c.y, c.z, D, em, s_em, lvl});
                }
            }
        }

        // from m-1 diagonal: gaps and jumps
        for (const XYZ& c : frontier_m1) {
            const Cell& pc = scores[key_of(c.x, c.y, c.z)];
            double pd = pc.s[D], pgg = pc.s[GG], psg = pc.s[SG];
            // gap in graph (consume sequence char)
            {
                int64_t nx = c.x, ny = c.y + step;
                if (in_bounds(nx, ny)) {
                    int s_em = positive ? seq[c.y] : seq[c.y - 1];
                    if (pd > NEG / 2)
                        push(nx, ny, c.z, GG, pd + s_open + s_extend,
                             BTrec{c.x, c.y, c.z, D, GAPC, s_em, -1});
                    if (pgg > NEG / 2)
                        push(nx, ny, c.z, GG, pgg + s_extend,
                             BTrec{c.x, c.y, c.z, GG, GAPC, s_em, -1});
                }
            }
            // gap in sequence (consume graph edge)
            {
                int64_t nx = c.x + step, ny = c.y;
                if (in_bounds(nx, ny)) {
                    int64_t node = node_of(c.x, c.z);
                    int64_t lvl = positive ? c.x : nx;
                    int64_t e0, e1;
                    if (positive) { e0 = out_offsets[node];
                                    e1 = out_offsets[node + 1]; }
                    else { e0 = in_offsets[node]; e1 = in_offsets[node + 1]; }
                    for (int64_t e = e0; e < e1; e++) {
                        int32_t eid = positive ? out_edges[e] : in_edges[e];
                        int64_t nz = positive ? node_z[edge_to[eid]]
                                              : node_z[edge_from[eid]];
                        int em = edge_emission[eid];
                        if (em != GAPC) {
                            if (pd > NEG / 2)
                                push(nx, ny, nz, SG, pd + s_open + s_extend,
                                     BTrec{c.x, c.y, c.z, D, em, GAPC, lvl});
                            if (psg > NEG / 2)
                                push(nx, ny, nz, SG, psg + s_extend,
                                     BTrec{c.x, c.y, c.z, SG, em, GAPC, lvl});
                        } else {
                            // graph gap edge: SG extension at graph-gap cost;
                            // non-affine D->D step
                            if (psg > NEG / 2)
                                push(nx, ny, nz, SG, psg + s_graph_gap,
                                     BTrec{c.x, c.y, c.z, SG, em, GAPC, lvl});
                            if (pd > NEG / 2)
                                push(nx, ny, nz, D, pd + s_graph_gap,
                                     BTrec{c.x, c.y, c.z, D, em, GAPC, lvl});
                        }
                    }
                }
            }
            // gap jumps (consume many all-gap graph levels)
            if (pd > NEG / 2) {
                int64_t node = node_of(c.x, c.z);
                if (positive) {
                    for (int64_t j = jump_out_offsets[node];
                         j < jump_out_offsets[node + 1]; j++) {
                        int32_t jid = jump_out[j];
                        int32_t tgt = jump_to[jid];
                        int64_t jx = node_level[tgt], jz = node_z[tgt];
                        int64_t jl = jump_len[jid];
                        if (in_bounds(jx, c.y))
                            push(jx, c.y, jz, D, pd + jl * s_graph_gap,
                                 BTrec{c.x, c.y, c.z, D, -2, -2, jl});
                    }
                } else {
                    for (int64_t j = jump_in_offsets[node];
                         j < jump_in_offsets[node + 1]; j++) {
                        int32_t jid = jump_in[j];
                        int32_t src = jump_from[jid];
                        int64_t jx = node_level[src], jz = node_z[src];
                        int64_t jl = jump_len[jid];
                        if (in_bounds(jx, c.y))
                            push(jx, c.y, jz, D, pd + jl * s_graph_gap,
                                 BTrec{c.x, c.y, c.z, D, -2, -2, jl});
                    }
                }
            }
        }

        // resolve candidates per cell (insertion order)
        new_cells.clear();
        for (const CandCell& cc : cand) {
            double vals[3] = {NEG, NEG, NEG};
            BTrec bts[3];
            bool hasb[3] = {false, false, false};
            for (int st = GG; st <= SG; st++)
                if (cc.has[st]) {
                    vals[st] = cc.best[st]; bts[st] = cc.bt[st];
                    hasb[st] = true;
                }
            // D candidates: pushed D values, then closing from GG/SG
            if (cc.has[D]) {
                vals[D] = cc.best[D]; bts[D] = cc.bt[D]; hasb[D] = true;
            }
            if (vals[GG] > NEG / 2 && (!hasb[D] || vals[GG] > vals[D])) {
                vals[D] = vals[GG];
                bts[D] = BTrec{cc.x, cc.y, cc.z, GG, -1, -1, -1};
                hasb[D] = true;
            }
            if (vals[SG] > NEG / 2 && (!hasb[D] || vals[SG] > vals[D])) {
                vals[D] = vals[SG];
                bts[D] = BTrec{cc.x, cc.y, cc.z, SG, -1, -1, -1};
                hasb[D] = true;
            }
            if (!hasb[D]) vals[D] = NEG;
            if (vals[D] < stop_thr) continue;
            uint64_t k = key_of(cc.x, cc.y, cc.z);
            auto it = scores.find(k);
            bool changed = false;
            Cell* cur;
            if (it == scores.end()) {
                Cell nc;
                for (int st = 0; st < 3; st++) {
                    nc.s[st] = vals[st];
                    nc.has_bt[st] = hasb[st];
                    if (hasb[st]) nc.bt[st] = bts[st];
                }
                cur = &scores.emplace(k, nc).first->second;
                changed = true;
            } else {
                cur = &it->second;
                for (int st = 0; st < 3; st++)
                    if (vals[st] > cur->s[st]) {
                        cur->s[st] = vals[st];
                        cur->bt[st] = bts[st];
                        cur->has_bt[st] = true;
                        changed = true;
                    }
            }
            if (changed) {
                new_cells.push_back({cc.x, cc.y, cc.z});
                if (cur->s[D] > current_max) {
                    current_max = cur->s[D];
                    maxima.clear();
                    maxima.push_back({cc.x, cc.y, cc.z});
                    last_improve = diag;
                } else if (cur->s[D] == current_max && cur->s[D] > 0) {
                    maxima.push_back({cc.x, cc.y, cc.z});
                    last_improve = diag;
                }
            }
        }

        // diagonal filtering: drop cells > threshold below the diagonal max
        if (!new_cells.empty()) {
            double dmax = NEG;
            for (const XYZ& c : new_cells) {
                double v = scores[key_of(c.x, c.y, c.z)].s[D];
                if (v > dmax) dmax = v;
            }
            std::vector<XYZ> kept;
            kept.reserve(new_cells.size());
            for (const XYZ& c : new_cells)
                if (dmax - scores[key_of(c.x, c.y, c.z)].s[D] <= diag_filter)
                    kept.push_back(c);
            frontier_m2 = std::move(frontier_m1);
            frontier_m1 = std::move(kept);
        } else {
            frontier_m2 = std::move(frontier_m1);
            frontier_m1.clear();
        }
    }

    if (current_max <= 0) return -1;
    XYZ end = maxima[0];
    double best_s = scores[key_of(end.x, end.y, end.z)].s[D];
    for (size_t i = 1; i < maxima.size(); i++) {
        double v = scores[key_of(maxima[i].x, maxima[i].y, maxima[i].z)].s[D];
        if (v > best_s) { best_s = v; end = maxima[i]; }
    }

    // backtrace
    std::vector<uint8_t> gch, sch;
    std::vector<int64_t> lvls;
    int64_t x = end.x, y = end.y, z = end.z;
    int st = D;
    while (!(x == start_level && y == start_seq && z == start_z && st == D)) {
        auto it = scores.find(key_of(x, y, z));
        if (it == scores.end() || !it->second.has_bt[st]) break;
        BTrec bt = it->second.bt[st];
        if (bt.em_g == -1) {
            // matrix switch, no emission
        } else if (bt.em_g == -2) {
            if (positive) {
                for (int64_t l = bt.px + bt.lvl - 1; l >= bt.px; l--) {
                    gch.push_back(GAPC); sch.push_back(GAPC);
                    lvls.push_back(l);
                }
            } else {
                for (int64_t l = x; l < x + bt.lvl; l++) {
                    gch.push_back(GAPC); sch.push_back(GAPC);
                    lvls.push_back(l);
                }
            }
        } else {
            gch.push_back((uint8_t)bt.em_g);
            sch.push_back((uint8_t)bt.em_s);
            lvls.push_back(bt.lvl);
        }
        x = bt.px; y = bt.py; z = bt.pz; st = bt.pst;
    }
    int64_t n = (int64_t)gch.size();
    if (n > out_cap) return -2;
    if (positive) {
        std::reverse(gch.begin(), gch.end());
        std::reverse(sch.begin(), sch.end());
        std::reverse(lvls.begin(), lvls.end());
    }
    if (n) {
        memcpy(out_graph, gch.data(), n);
        memcpy(out_seq_c, sch.data(), n);
        memcpy(out_levels, lvls.data(), n * sizeof(int64_t));
    }
    *out_score = best_s;
    out_end[0] = end.x; out_end[1] = end.y; out_end[2] = end.z;
    return n;
}

// ------------------------------------------------------- pair reduction
// Diploid pair log-likelihoods (HLATyper.cpp:2280-2364, the reference's
// only OpenMP-parallel loop; semantics of ops/pair_ll.py
// pair_ll_reduction_numpy):
//   out[c1,c2] = sum_r ( log(1/2) + max(a,b) + log1p(exp(-|a-b|)) )
//              = 0.5*(rowsum[c1]+rowsum[c2]) + R*log(1/2)
//                + sum_r ( 0.5*|a-b| + softplus(-|a-b|) )
// The |a-b| part is accumulated in f64 (magnitudes ~1e3, sums ~1e6); the
// softplus tail is computed in f32 (bounded by log 2) with the standard
// cephes exp/log polynomials, and skipped outright when every lane has
// d >= 17 (softplus < 4.2e-8).  NOTE (r5, measured on real IMGT LL
// matrices): real data has ~38% of cells with d>=17 but scattered, so
// this vector-wide skip essentially never fires there (it pays on
// well-separated synthetic benchmarks); softplus evaluation is ~72% of
// kernel CPU at the real working point and is at its evaluation floor —
// see docs/ROADMAP.md round-5 dead-end entry before attempting an
// approximation.  Tiled over (read chunks x 32 c1-rows) so the streamed
// row data stays cache-resident; each (c1,c2) pair is summed by exactly
// one thread in fixed chunk order, so output is deterministic for any
// thread count.

#if defined(__AVX512F__)
static inline __m512 pair_exp512_ps(__m512 x) {
    // exp(x) for x in [-17, 0] (cephes polynomial, scalef scaling)
    const __m512 log2ef = _mm512_set1_ps(1.44269504088896341f);
    const __m512 c1 = _mm512_set1_ps(0.693359375f);
    const __m512 c2 = _mm512_set1_ps(-2.12194440e-4f);
    __m512 fx = _mm512_roundscale_ps(_mm512_mul_ps(x, log2ef),
                                     _MM_FROUND_TO_NEAREST_INT |
                                     _MM_FROUND_NO_EXC);
    __m512 t = _mm512_fnmadd_ps(fx, c1, x);
    t = _mm512_fnmadd_ps(fx, c2, t);
    __m512 z = _mm512_mul_ps(t, t);
    __m512 y = _mm512_set1_ps(1.9875691500e-4f);
    y = _mm512_fmadd_ps(y, t, _mm512_set1_ps(1.3981999507e-3f));
    y = _mm512_fmadd_ps(y, t, _mm512_set1_ps(8.3334519073e-3f));
    y = _mm512_fmadd_ps(y, t, _mm512_set1_ps(4.1665795894e-2f));
    y = _mm512_fmadd_ps(y, t, _mm512_set1_ps(1.6666665459e-1f));
    y = _mm512_fmadd_ps(y, t, _mm512_set1_ps(5.0000001201e-1f));
    y = _mm512_fmadd_ps(y, z, _mm512_add_ps(t, _mm512_set1_ps(1.0f)));
    return _mm512_scalef_ps(y, fx);
}

static inline __m512 pair_log1p512_ps(__m512 y) {
    // log1p(y) for y in [0, 1] as y * q(y), q a degree-9 Chebyshev fit of
    // log1p(y)/y on [0,1] (design err 2.8e-9; f32 Horner eval brings the
    // total to ~1.1e-7 abs AND rel — the y-factored form keeps the
    // exp(-d)->0 tail exact in relative terms).  Replaces the former
    // general-range cephes log of (1 + y): the argument is always in
    // (1, 2], so mantissa/exponent range reduction was pure overhead.
    __m512 p = _mm512_set1_ps(-3.1760570128e-03f);
    p = _mm512_fmadd_ps(p, y, _mm512_set1_ps(1.9542528316e-02f));
    p = _mm512_fmadd_ps(p, y, _mm512_set1_ps(-5.6373614818e-02f));
    p = _mm512_fmadd_ps(p, y, _mm512_set1_ps(1.0543623567e-01f));
    p = _mm512_fmadd_ps(p, y, _mm512_set1_ps(-1.5269666910e-01f));
    p = _mm512_fmadd_ps(p, y, _mm512_set1_ps(1.9663274288e-01f));
    p = _mm512_fmadd_ps(p, y, _mm512_set1_ps(-2.4951615930e-01f));
    p = _mm512_fmadd_ps(p, y, _mm512_set1_ps(3.3329710364e-01f));
    p = _mm512_fmadd_ps(p, y, _mm512_set1_ps(-4.9999892712e-01f));
    p = _mm512_fmadd_ps(p, y, _mm512_set1_ps(1.0f));
    return _mm512_mul_ps(y, p);
}

// sum over one read chunk of 0.5*|a-b| + softplus(-|a-b|)
static double pair_chunk_sum_avx512(const double* __restrict a,
                                    const double* __restrict b,
                                    int64_t n) {
    const __m512d half = _mm512_set1_pd(0.5);
    const __m512d cut = _mm512_set1_pd(17.0);
    __m512d acc0 = _mm512_setzero_pd();
    __m512d acc1 = _mm512_setzero_pd();
    int64_t i = 0;
    for (; i + 16 <= n; i += 16) {
        __m512d d0 = _mm512_abs_pd(_mm512_sub_pd(
            _mm512_loadu_pd(a + i), _mm512_loadu_pd(b + i)));
        __m512d d1 = _mm512_abs_pd(_mm512_sub_pd(
            _mm512_loadu_pd(a + i + 8), _mm512_loadu_pd(b + i + 8)));
        acc0 = _mm512_fmadd_pd(half, d0, acc0);
        acc1 = _mm512_fmadd_pd(half, d1, acc1);
        __mmask8 m0 = _mm512_cmp_pd_mask(d0, cut, _CMP_LT_OQ);
        __mmask8 m1 = _mm512_cmp_pd_mask(d1, cut, _CMP_LT_OQ);
        if (!(m0 | m1)) continue;       // softplus < 4.2e-8: negligible
        // clamp masked-off lanes to the cutoff BEFORE exp: d ~ 100 would
        // produce denormal exp() results whose microcode assists cost 5x
        // (measured on well-separated likelihoods)
        __m512 df = _mm512_min_ps(_mm512_set1_ps(17.0f), _mm512_insertf32x8(
            _mm512_castps256_ps512(_mm512_cvtpd_ps(d0)),
            _mm512_cvtpd_ps(d1), 1));
        __m512 sp = pair_log1p512_ps(
            pair_exp512_ps(_mm512_sub_ps(_mm512_setzero_ps(), df)));
        acc0 = _mm512_add_pd(acc0, _mm512_maskz_cvtps_pd(
            m0, _mm512_extractf32x8_ps(sp, 0)));
        acc1 = _mm512_add_pd(acc1, _mm512_maskz_cvtps_pd(
            m1, _mm512_extractf32x8_ps(sp, 1)));
    }
    double s = _mm512_reduce_add_pd(acc0) + _mm512_reduce_add_pd(acc1);
    for (; i < n; ++i) {
        double d = a[i] - b[i];
        if (d < 0) d = -d;
        s += 0.5 * d;
        if (d < 17.0) s += log1p((float)exp((float)-d));
    }
    return s;
}
#endif  // __AVX512F__

static double pair_chunk_sum_scalar(const double* a, const double* b,
                                    int64_t n) {
    double s = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        double d = a[i] - b[i];
        if (d < 0) d = -d;
        s += 0.5 * d;
        if (d < 17.0) s += log1p(exp(-d));
    }
    return s;
}

#if defined(__AVX512F__)
// f32-input variant: cvt to f64 on load (exact), then byte-identical
// accumulation structure to pair_chunk_sum_avx512 — the typing LL matrix
// is f32 [C,R], and converting it up-front costs a ~300 MB copy per locus
// at IMGT scale (measured ~4 s under contention).
static double pair_chunk_sum_avx512_f32(const float* __restrict a,
                                        const float* __restrict b,
                                        int64_t n) {
    const __m512d half = _mm512_set1_pd(0.5);
    const __m512d cut = _mm512_set1_pd(17.0);
    __m512d acc0 = _mm512_setzero_pd();
    __m512d acc1 = _mm512_setzero_pd();
    int64_t i = 0;
    for (; i + 16 <= n; i += 16) {
        __m512 av = _mm512_loadu_ps(a + i);
        __m512 bv = _mm512_loadu_ps(b + i);
        __m512d d0 = _mm512_abs_pd(_mm512_sub_pd(
            _mm512_cvtps_pd(_mm512_extractf32x8_ps(av, 0)),
            _mm512_cvtps_pd(_mm512_extractf32x8_ps(bv, 0))));
        __m512d d1 = _mm512_abs_pd(_mm512_sub_pd(
            _mm512_cvtps_pd(_mm512_extractf32x8_ps(av, 1)),
            _mm512_cvtps_pd(_mm512_extractf32x8_ps(bv, 1))));
        acc0 = _mm512_fmadd_pd(half, d0, acc0);
        acc1 = _mm512_fmadd_pd(half, d1, acc1);
        __mmask8 m0 = _mm512_cmp_pd_mask(d0, cut, _CMP_LT_OQ);
        __mmask8 m1 = _mm512_cmp_pd_mask(d1, cut, _CMP_LT_OQ);
        if (!(m0 | m1)) continue;
        __m512 df = _mm512_min_ps(_mm512_set1_ps(17.0f), _mm512_insertf32x8(
            _mm512_castps256_ps512(_mm512_cvtpd_ps(d0)),
            _mm512_cvtpd_ps(d1), 1));
        __m512 sp = pair_log1p512_ps(
            pair_exp512_ps(_mm512_sub_ps(_mm512_setzero_ps(), df)));
        acc0 = _mm512_add_pd(acc0, _mm512_maskz_cvtps_pd(
            m0, _mm512_extractf32x8_ps(sp, 0)));
        acc1 = _mm512_add_pd(acc1, _mm512_maskz_cvtps_pd(
            m1, _mm512_extractf32x8_ps(sp, 1)));
    }
    double s = _mm512_reduce_add_pd(acc0) + _mm512_reduce_add_pd(acc1);
    for (; i < n; ++i) {
        double d = (double)a[i] - (double)b[i];
        if (d < 0) d = -d;
        s += 0.5 * d;
        if (d < 17.0) s += log1p((float)exp((float)-d));
    }
    return s;
}
#endif  // __AVX512F__

static double pair_chunk_sum_scalar_f32(const float* a, const float* b,
                                        int64_t n) {
    double s = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        double d = (double)a[i] - (double)b[i];
        if (d < 0) d = -d;
        s += 0.5 * d;
        if (d < 17.0) s += log1p(exp(-d));
    }
    return s;
}

// ------------------------------------------------------------ text output
// CPython-repr float formatting + bulk line assembly for the
// R1_PP_<locus>_pairs.txt posterior dump (HLATyper.cpp:2382-2404 output
// contract).  At IMGT scale the dump is C(C+1)/2 ~ 2.4M lines (~120 MB)
// per locus and Python-side repr dominates the write.  std::to_chars
// (scientific, no precision) yields the same shortest correctly-rounded
// digit string CPython's float_repr uses; we re-lay it out under CPython's
// rule: fixed iff -4 <= exp10 < 16, else scientific with a signed
// >=2-digit exponent.  Byte-parity vs repr() is locked by
// tests/test_native_parity.py.
static int py_repr_double(double v, char* out) {
    char* p = out;
    if (std::isnan(v)) { std::memcpy(p, "nan", 3); return 3; }
    if (std::signbit(v)) { *p++ = '-'; v = -v; }
    if (std::isinf(v)) {
        std::memcpy(p, "inf", 3);
        return (int)(p - out) + 3;
    }
    if (v == 0.0) {
        std::memcpy(p, "0.0", 3);
        return (int)(p - out) + 3;
    }
    char sci[48];
    auto res = std::to_chars(sci, sci + sizeof(sci), v,
                             std::chars_format::scientific);
    // parse "d[.ddd]e(+|-)XX" -> digit string D + decimal exponent E
    char digits[24];
    int nd = 0;
    const char* s = sci;
    digits[nd++] = *s++;
    if (*s == '.') {
        ++s;
        while (*s != 'e') digits[nd++] = *s++;
    }
    ++s;                                     // skip 'e'
    int esign = (*s++ == '-') ? -1 : 1;
    int E = 0;
    while (s < res.ptr) E = E * 10 + (*s++ - '0');
    E *= esign;
    if (E < -4 || E >= 16) {                 // scientific, CPython layout
        *p++ = digits[0];
        if (nd > 1) {
            *p++ = '.';
            std::memcpy(p, digits + 1, (size_t)(nd - 1));
            p += nd - 1;
        }
        *p++ = 'e';
        *p++ = E < 0 ? '-' : '+';
        int ea = E < 0 ? -E : E;
        char eb[8];
        int ne = 0;
        do { eb[ne++] = (char)('0' + ea % 10); ea /= 10; } while (ea);
        if (ne < 2) eb[ne++] = '0';
        while (ne) *p++ = eb[--ne];
    } else if (E < 0) {                      // 0.00ddd
        *p++ = '0'; *p++ = '.';
        for (int i = 0; i < -E - 1; ++i) *p++ = '0';
        std::memcpy(p, digits, (size_t)nd);
        p += nd;
    } else if (E >= nd - 1) {                // ddd000.0 (integral)
        std::memcpy(p, digits, (size_t)nd);
        p += nd;
        for (int i = 0; i < E - (nd - 1); ++i) *p++ = '0';
        *p++ = '.'; *p++ = '0';
    } else {                                 // ddd.ddd
        std::memcpy(p, digits, (size_t)(E + 1));
        p += E + 1;
        *p++ = '.';
        std::memcpy(p, digits + E + 1, (size_t)(nd - E - 1));
        p += nd - E - 1;
    }
    return (int)(p - out);
}

// test/bench entry: repr one double into out (>=32 bytes), returns length
extern "C" int hla_repr_double(double v, char* out) {
    return py_repr_double(v, out);
}

// Assemble the full pair-dump body (no header line):
//   ids[a] '/' ids[b] '\t' repr(P) '\t' repr(LL) '\t' repr(MM) '\n'
// ids_blob/ids_off: C id strings, offsets int64[C+1].  *out is malloc'd
// (caller frees with hla_free), length in *out_len.  Returns 0 on success.
extern "C" int hla_format_pairs(
    const int32_t* a_idx, const int32_t* b_idx,
    const double* P, const double* LL, const double* MM, int64_t n,
    const uint8_t* ids_blob, const int64_t* ids_off, int64_t C,
    char** out, int64_t* out_len, int n_threads) {
    int nt = n_threads > 0 ? n_threads : 1;
    if (nt > 8) nt = 8;
    if ((int64_t)nt > n) nt = n > 0 ? (int)n : 1;
    std::vector<std::string> bufs((size_t)nt);
    auto worker = [&](int t) {
        int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
        std::string& b = bufs[(size_t)t];
        b.reserve((size_t)(hi - lo) * 64);
        char num[36];
        for (int64_t i = lo; i < hi; ++i) {
            int32_t a = a_idx[i], c = b_idx[i];
            b.append((const char*)ids_blob + ids_off[a],
                     (size_t)(ids_off[a + 1] - ids_off[a]));
            b.push_back('/');
            b.append((const char*)ids_blob + ids_off[c],
                     (size_t)(ids_off[c + 1] - ids_off[c]));
            b.push_back('\t');
            b.append(num, (size_t)py_repr_double(P[i], num));
            b.push_back('\t');
            b.append(num, (size_t)py_repr_double(LL[i], num));
            b.push_back('\t');
            b.append(num, (size_t)py_repr_double(MM[i], num));
            b.push_back('\n');
        }
    };
    if (nt == 1) {
        worker(0);
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t) threads.emplace_back(worker, t);
        for (auto& th : threads) th.join();
    }
    size_t total = 0;
    for (auto& b : bufs) total += b.size();
    char* buf = (char*)std::malloc(total ? total : 1);
    if (!buf) return -1;
    size_t off = 0;
    for (auto& b : bufs) {
        std::memcpy(buf + off, b.data(), b.size());
        off += b.size();
    }
    *out = buf;
    *out_len = (int64_t)total;
    return 0;
}

template <typename T>
static double pair_chunk_sum(const T* a, const T* b, int64_t n);

template <>
double pair_chunk_sum<double>(const double* a, const double* b, int64_t n) {
#if defined(__AVX512F__)
    return pair_chunk_sum_avx512(a, b, n);
#else
    return pair_chunk_sum_scalar(a, b, n);
#endif
}

template <>
double pair_chunk_sum<float>(const float* a, const float* b, int64_t n) {
#if defined(__AVX512F__)
    return pair_chunk_sum_avx512_f32(a, b, n);
#else
    return pair_chunk_sum_scalar_f32(a, b, n);
#endif
}

template <typename T>
static void pair_ll_impl(const T* L, int64_t C, int64_t R,
                         double* out, int n_threads) {
    const double LOG_HALF = -0.69314718055994530942;
    std::vector<double> rowsum((size_t)C);
    for (int64_t c = 0; c < C; ++c) {
        double s = 0.0;
        const T* row = L + c * R;
        for (int64_t r = 0; r < R; ++r) s += (double)row[r];
        rowsum[(size_t)c] = s;
    }
    int nt = n_threads > 0 ? n_threads : 1;
    const int64_t TILE = 32;          // c1 rows per tile
    const int64_t RCHUNK = 1024;      // 8 KB/row: tile rows stay in L2
    int64_t n_tiles = (C + TILE - 1) / TILE;
    auto worker = [&](int t) {
        for (int64_t tile = t; tile < n_tiles; tile += nt) {
            int64_t c1_lo = tile * TILE;
            int64_t c1_hi = c1_lo + TILE < C ? c1_lo + TILE : C;
            for (int64_t c1 = c1_lo; c1 < c1_hi; ++c1)
                std::memset(out + c1 * C + c1, 0,
                            (size_t)(C - c1) * sizeof(double));
            for (int64_t r0 = 0; r0 < R; r0 += RCHUNK) {
                int64_t rn = R - r0 < RCHUNK ? R - r0 : RCHUNK;
                // c2 outer / c1 inner: the b chunk stays L1-resident
                // across the tile's 32 a rows (a rows live in L2)
                for (int64_t c2 = c1_lo; c2 < C; ++c2) {
                    const T* b = L + c2 * R + r0;
                    int64_t c1_top = c2 + 1 < c1_hi ? c2 + 1 : c1_hi;
                    for (int64_t c1 = c1_lo; c1 < c1_top; ++c1)
                        out[c1 * C + c2] += pair_chunk_sum<T>(
                            L + c1 * R + r0, b, rn);
                }
            }
            for (int64_t c1 = c1_lo; c1 < c1_hi; ++c1) {
                for (int64_t c2 = c1; c2 < C; ++c2) {
                    double v = out[c1 * C + c2]
                        + 0.5 * (rowsum[(size_t)c1] + rowsum[(size_t)c2])
                        + LOG_HALF * (double)R;
                    out[c1 * C + c2] = v;
                    out[c2 * C + c1] = v;
                }
            }
        }
    };
    if (nt == 1) { worker(0); return; }
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
}

// Sparse-delta cluster LL (ops/pair_ll.cluster_read_ll_delta): the allele
// clusters of one locus are near-identical (the reference's segment
// matrices differ in a few % of columns, HLATyper.cpp:1198-1299), so
// LL[c,:] = base(consensus row) + sum over the cluster's few differing
// columns of (T[plus_col] - T[minus_col]).  Replaces the dense
// [C,J6]x[J6,R] sgemm of cluster_read_ll with O(ndiff x R) row-axpy work
// (~100x fewer flops at IMGT scale).  T / M are the TRANSPOSED [J*6, R]
// contribution tensors (rows contiguous over reads); deltas accumulate
// in f64 like the numpy reference, outputs are f32 [C, R].
// out_stride: elements between consecutive cluster rows of LL/MM (lets a
// read-chunk write directly into a column slice of the full [C, R_total]
// matrices — fresh 100MB+ allocations per call hit this VM's page-fault
// pathology, costing seconds of stime).
extern "C" void hla_cluster_ll_delta(
    const float* T, const float* M,
    const int64_t* base_cols,            // [J] flat [J*6] indices
    const int64_t* plus_cols,            // [ndiff]
    const int64_t* minus_cols,           // [ndiff]
    const int64_t* starts,               // [C+1] per-cluster diff ranges
    int64_t C, int64_t J, int64_t R, int64_t out_stride,
    float* LL, float* MM, int n_threads) {
    // consensus base rows, accumulated in f64
    std::vector<double> baseT((size_t)R, 0.0), baseM((size_t)R, 0.0);
    for (int64_t j = 0; j < J; ++j) {
        const float* rt = T + base_cols[j] * R;
        const float* rm = M + base_cols[j] * R;
        for (int64_t r = 0; r < R; ++r) {
            baseT[(size_t)r] += (double)rt[r];
            baseM[(size_t)r] += (double)rm[r];
        }
    }
    std::vector<float> baseTf((size_t)R), baseMf((size_t)R);
    for (int64_t r = 0; r < R; ++r) {
        baseTf[(size_t)r] = (float)baseT[(size_t)r];
        baseMf[(size_t)r] = (float)baseM[(size_t)r];
    }
    int nt = n_threads > 0 ? n_threads : 1;
    auto worker = [&](int t) {
        std::vector<double> acc((size_t)R);
        for (int64_t c = t; c < C; c += nt) {
            int64_t k0 = starts[c], k1 = starts[c + 1];
            for (int pass = 0; pass < 2; ++pass) {
                const float* src = pass == 0 ? T : M;
                const double* base = pass == 0 ? baseT.data() : baseM.data();
                const float* basef = pass == 0 ? baseTf.data()
                                               : baseMf.data();
                float* out_row = (pass == 0 ? LL : MM) + c * out_stride;
                if (k1 == k0) {          // cluster == consensus
                    std::memcpy(out_row, basef, (size_t)R * sizeof(float));
                    continue;
                }
                std::memcpy(acc.data(), base, (size_t)R * sizeof(double));
                for (int64_t k = k0; k < k1; ++k) {
                    const float* p = src + plus_cols[k] * R;
                    const float* m = src + minus_cols[k] * R;
                    for (int64_t r = 0; r < R; ++r)
                        acc[(size_t)r] += (double)p[r] - (double)m[r];
                }
                for (int64_t r = 0; r < R; ++r)
                    out_row[r] = (float)acc[(size_t)r];
            }
        }
    };
    if (nt == 1) { worker(0); return; }
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
}

extern "C" void hla_pair_ll(const double* L, int64_t C, int64_t R,
                            double* out, int n_threads) {
    pair_ll_impl<double>(L, C, R, out, n_threads);
}

// f32 input (the typing LL matrix's dtype): cvt-on-load inside the kernel
// — bit-identical to converting the matrix to f64 first (the cvt is
// exact and the accumulation structure is shared), without the ~300 MB
// up-front copy per IMGT-scale locus.
extern "C" void hla_pair_ll_f32(const float* L, int64_t C, int64_t R,
                                double* out, int n_threads) {
    pair_ll_impl<float>(L, C, R, out, n_threads);
}

// ---------------------------------------------------------------------------
// Canonical k-mer count index build (typer.KmerCountIndex.build; the
// kMer counting of HLATyper.cpp:999-1028): rolling canonical encode over
// the '\0'-joined read set, compact the valid codes, bucketed parallel
// sort, run-length count.  Outputs are malloc'd arrays (caller frees both
// with hla_free); returns the number of unique codes, -1 on alloc failure.
// Results are identical to sort+unique in any order (sorted uniques).
// ---------------------------------------------------------------------------
extern "C" int64_t hla_kmer_count_build(
    const uint8_t* seq, int64_t n, int64_t k, int n_threads,
    uint64_t** out_codes, int64_t** out_counts) {
    *out_codes = nullptr; *out_counts = nullptr;
    int64_t n_out = n - k + 1;
    if (n_out <= 0) return 0;
    int nt = n_threads > 0 ? n_threads : 1;
    if (nt > 16) nt = 16;
    // 1) encode (canonical) + validity, then per-thread compact
    std::vector<uint64_t> codes((size_t)n_out);
    std::vector<uint8_t> valid((size_t)n_out);
    hla_encode_kmers_c(seq, n, k, codes.data(), valid.data(), nt, 1);
    // 2) partition valid codes into 2^PB buckets by top bits (canonical
    //    codes are ~uniform there), counting per (thread, bucket) first so
    //    each thread scatters into disjoint slots
    constexpr int PB = 10;
    const int NB = 1 << PB;
    const int shift = (2 * (int)k > PB) ? (2 * (int)k - PB) : 0;
    std::vector<int64_t> tb_count((size_t)nt * NB, 0);
    int64_t chunk = (n_out + nt - 1) / nt;
    {
        std::vector<std::thread> th;
        for (int t = 0; t < nt; t++) th.emplace_back([&, t]() {
            int64_t lo = t * chunk, hi = std::min(lo + chunk, n_out);
            int64_t* cnt = tb_count.data() + (size_t)t * NB;
            for (int64_t i = lo; i < hi; i++)
                if (valid[i]) cnt[codes[i] >> shift]++;
        });
        for (auto& x : th) x.join();
    }
    // prefix sums: bucket starts, then per-thread write cursors
    std::vector<int64_t> bstart(NB + 1, 0);
    for (int b = 0; b < NB; b++) {
        int64_t s = 0;
        for (int t = 0; t < nt; t++) s += tb_count[(size_t)t * NB + b];
        bstart[b + 1] = bstart[b] + s;
    }
    int64_t n_valid = bstart[NB];
    if (n_valid == 0) return 0;
    std::vector<int64_t> cursor((size_t)nt * NB);
    for (int b = 0; b < NB; b++) {
        int64_t at = bstart[b];
        for (int t = 0; t < nt; t++) {
            cursor[(size_t)t * NB + b] = at;
            at += tb_count[(size_t)t * NB + b];
        }
    }
    std::vector<uint64_t> part((size_t)n_valid);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < nt; t++) th.emplace_back([&, t]() {
            int64_t lo = t * chunk, hi = std::min(lo + chunk, n_out);
            int64_t* cur = cursor.data() + (size_t)t * NB;
            for (int64_t i = lo; i < hi; i++)
                if (valid[i]) part[(size_t)cur[codes[i] >> shift]++] = codes[i];
        });
        for (auto& x : th) x.join();
    }
    codes.clear(); codes.shrink_to_fit();
    valid.clear(); valid.shrink_to_fit();
    // 3) sort buckets in parallel (dynamic work stealing over bucket ids)
    {
        std::atomic<int> next{0};
        std::vector<std::thread> th;
        for (int t = 0; t < nt; t++) th.emplace_back([&]() {
            for (;;) {
                int b = next.fetch_add(1);
                if (b >= NB) break;
                std::sort(part.begin() + bstart[b],
                          part.begin() + bstart[b + 1]);
            }
        });
        for (auto& x : th) x.join();
    }
    // 4) run-length count per bucket (bucket boundaries never split a run:
    //    equal codes share a bucket), then compact into the output arrays
    std::vector<int64_t> uniq_in_bucket(NB, 0);
    {
        std::vector<std::thread> th;
        std::atomic<int> next{0};
        for (int t = 0; t < nt; t++) th.emplace_back([&]() {
            for (;;) {
                int b = next.fetch_add(1);
                if (b >= NB) break;
                int64_t u = 0;
                for (int64_t i = bstart[b]; i < bstart[b + 1]; i++)
                    if (i == bstart[b] || part[i] != part[i - 1]) u++;
                uniq_in_bucket[b] = u;
            }
        });
        for (auto& x : th) x.join();
    }
    std::vector<int64_t> ustart(NB + 1, 0);
    for (int b = 0; b < NB; b++) ustart[b + 1] = ustart[b] + uniq_in_bucket[b];
    int64_t n_uniq = ustart[NB];
    uint64_t* oc = (uint64_t*)malloc((size_t)n_uniq * sizeof(uint64_t));
    int64_t* on = (int64_t*)malloc((size_t)n_uniq * sizeof(int64_t));
    if (!oc || !on) { free(oc); free(on); return -1; }
    {
        std::vector<std::thread> th;
        std::atomic<int> next{0};
        for (int t = 0; t < nt; t++) th.emplace_back([&]() {
            for (;;) {
                int b = next.fetch_add(1);
                if (b >= NB) break;
                int64_t w = ustart[b] - 1;
                for (int64_t i = bstart[b]; i < bstart[b + 1]; i++) {
                    if (i == bstart[b] || part[i] != part[i - 1]) {
                        w++;
                        oc[w] = part[i];
                        on[w] = 1;
                    } else on[w]++;
                }
            }
        });
        for (auto& x : th) x.join();
    }
    *out_codes = oc; *out_counts = on;
    return n_uniq;
}

// ---------------------------------------------------------------------------
// graph.txt section parsers (PRG._from_text_fast native core;
// /root/reference readGraph role, Graph.cpp:77-160).  Both parse the raw
// section bytes ('|||'-separated fields, one row per line, no SLASH
// escapes — the python caller guards those) into flat arrays, threaded by
// byte-range.  Returns the row count, or -1 on any malformed row (the
// caller falls back to the python parsers).  All outputs are malloc'd;
// caller frees with hla_free.
// ---------------------------------------------------------------------------
namespace prgparse {

// Flat open-addressing string_view intern table (FNV-1a, linear probe).
// Real PRGs have ~one locus name per level (3M unique names in a 3.7M-row
// section): std::unordered_map paid a node allocation per unique name —
// ~6M mallocs per parse between the per-thread maps and the merge.
struct InternTable {
    std::vector<int64_t> slots;          // index into names+1, 0 = empty
    std::vector<std::string_view> names;
    std::vector<uint64_t> hashes;
    uint64_t mask = 0;

    static uint64_t hash_of(std::string_view s) {
        uint64_t h = 1469598103934665603ull;
        for (char c : s) { h ^= (uint8_t)c; h *= 1099511628211ull; }
        return h | 1;                    // never 0
    }
    void reserve_names(size_t n) {
        size_t cap = 16;
        while (cap < n * 2) cap <<= 1;
        slots.assign(cap, 0);
        mask = cap - 1;
        names.reserve(n);
        hashes.reserve(n);
    }
    void grow() {
        size_t cap = (mask + 1) * 2;
        slots.assign(cap, 0);
        mask = cap - 1;
        for (size_t i = 0; i < names.size(); i++) {
            uint64_t p = hashes[i] & mask;
            while (slots[p]) p = (p + 1) & mask;
            slots[p] = (int64_t)i + 1;
        }
    }
    int32_t intern(std::string_view s) {
        if (slots.empty()) reserve_names(64);
        if (names.size() * 2 >= mask + 1) grow();
        uint64_t h = hash_of(s);
        uint64_t p = h & mask;
        while (slots[p]) {
            int64_t id = slots[p] - 1;
            if (hashes[id] == h && names[id] == s) return (int32_t)id;
            p = (p + 1) & mask;
        }
        slots[p] = (int64_t)names.size() + 1;
        names.push_back(s);
        hashes.push_back(h);
        return (int32_t)names.size() - 1;
    }
    int32_t find(std::string_view s) const {   // -1 when absent
        if (slots.empty()) return -1;
        uint64_t h = hash_of(s);
        uint64_t p = h & mask;
        while (slots[p]) {
            int64_t id = slots[p] - 1;
            if (hashes[id] == h && names[id] == s) return (int32_t)id;
            p = (p + 1) & mask;
        }
        return -1;
    }
};

struct Range { int64_t lo, hi, rows; };

// split [0, n) into nt ranges aligned to '\n'; counts rows per range
static std::vector<Range> split_rows(const uint8_t* sec, int64_t n, int nt) {
    std::vector<Range> rs;
    int64_t chunk = (n + nt - 1) / nt;
    int64_t lo = 0;
    for (int t = 0; t < nt && lo < n; t++) {
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        while (hi < n && sec[hi - 1] != '\n') hi++;
        rs.push_back({lo, hi, 0});
        lo = hi;
    }
    std::vector<std::thread> th;
    for (auto& r : rs) th.emplace_back([&r, sec]() {
        int64_t c = 0;
        for (int64_t i = r.lo; i < r.hi; i++) if (sec[i] == '\n') c++;
        if (r.hi > r.lo && sec[r.hi - 1] != '\n') c++;   // unterminated tail
        r.rows = c;
    });
    for (auto& x : th) x.join();
    return rs;
}

static inline bool parse_i64(const uint8_t* b, const uint8_t* e,
                             int64_t* out) {
    if (b == e) return false;
    int64_t v = 0;
    bool neg = false;
    if (*b == '-') { neg = true; b++; if (b == e) return false; }
    for (; b < e; b++) {
        if (*b < '0' || *b > '9') return false;
        v = v * 10 + (*b - '0');
    }
    *out = neg ? -v : v;
    return true;
}

// field is "0" or empty -> 0, else 1 (PRG terminal/pgf rule)
static inline uint8_t flag_of(const uint8_t* b, const uint8_t* e) {
    return !(b == e || (e - b == 1 && *b == '0'));
}

// advance past one field: [*p, returned pos) is the field, sep skipped.
// sep is "|||"; end of row at '\n' or section end.
static inline bool next_field(const uint8_t* sec, int64_t n, int64_t* p,
                              int64_t* f_lo, int64_t* f_hi, bool* row_end) {
    int64_t i = *p;
    int64_t lo = i;
    while (i < n && sec[i] != '\n') {
        if (sec[i] == '|' && i + 2 < n && sec[i + 1] == '|'
            && sec[i + 2] == '|') {
            *f_lo = lo; *f_hi = i; *p = i + 3; *row_end = false;
            return true;
        }
        i++;
    }
    *f_lo = lo; *f_hi = i; *p = (i < n) ? i + 1 : i; *row_end = true;
    return true;
}

}  // namespace prgparse

extern "C" int64_t hla_parse_prg_nodes(
    const uint8_t* sec, int64_t n, int n_threads,
    int64_t** out_orig, int64_t** out_level, uint8_t** out_term) {
    using namespace prgparse;
    *out_orig = *out_level = nullptr; *out_term = nullptr;
    int nt = n_threads > 0 ? n_threads : 1;
    if (nt > 8) nt = 8;
    auto ranges = split_rows(sec, n, nt);
    int64_t total = 0;
    std::vector<int64_t> base(ranges.size());
    for (size_t i = 0; i < ranges.size(); i++) {
        base[i] = total; total += ranges[i].rows;
    }
    int64_t* o_orig = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
    int64_t* o_lv = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
    uint8_t* o_tm = (uint8_t*)malloc(total ? total : 1);
    if (!o_orig || !o_lv || !o_tm) {
        free(o_orig); free(o_lv); free(o_tm); return -1;
    }
    std::atomic<int> bad{0};
    std::vector<std::thread> th;
    for (size_t t = 0; t < ranges.size(); t++) th.emplace_back([&, t]() {
        int64_t p = ranges[t].lo, row = base[t];
        const int64_t hi = ranges[t].hi;
        while (p < hi && !bad.load(std::memory_order_relaxed)) {
            int64_t f_lo, f_hi; bool row_end;
            // field 0: orig id
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (f_lo == f_hi && row_end) continue;     // blank line
            if (row_end || !parse_i64(sec + f_lo, sec + f_hi,
                                      &o_orig[row])) { bad = 1; return; }
            // field 1: level
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (row_end || !parse_i64(sec + f_lo, sec + f_hi,
                                      &o_lv[row])) { bad = 1; return; }
            // field 2: terminal flag (last field)
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (!row_end) { bad = 1; return; }
            o_tm[row] = flag_of(sec + f_lo, sec + f_hi);
            row++;
        }
        if (!bad.load() && row != base[t] + ranges[t].rows) {
            // blank lines shrank the count: compact later via sentinel
            for (int64_t r = row; r < base[t] + ranges[t].rows; r++)
                o_orig[r] = INT64_MIN;   // mark unused slot
        }
    });
    for (auto& x : th) x.join();
    if (bad.load()) {
        free(o_orig); free(o_lv); free(o_tm); return -1;
    }
    // compact out blank-line slots (rare)
    int64_t w = 0;
    for (int64_t r = 0; r < total; r++) {
        if (o_orig[r] == INT64_MIN) continue;
        if (w != r) { o_orig[w] = o_orig[r]; o_lv[w] = o_lv[r];
                      o_tm[w] = o_tm[r]; }
        w++;
    }
    *out_orig = o_orig; *out_level = o_lv; *out_term = o_tm;
    return w;
}

extern "C" int64_t hla_parse_prg_edges(
    const uint8_t* sec, int64_t n, int n_threads,
    int64_t** out_from, int64_t** out_to, uint8_t** out_cc,
    int32_t** out_locus, uint8_t** out_pgf,
    uint8_t** out_lab_blob, int64_t** out_lab_off, int64_t* out_lab_len,
    uint8_t** out_loc_blob, int64_t** out_loc_off, int64_t* out_n_locus) {
    using namespace prgparse;
    *out_from = *out_to = nullptr; *out_cc = *out_pgf = nullptr;
    *out_locus = nullptr; *out_lab_blob = nullptr; *out_lab_off = nullptr;
    *out_loc_blob = nullptr; *out_loc_off = nullptr;
    *out_lab_len = 0; *out_n_locus = 0;
    int nt = n_threads > 0 ? n_threads : 1;
    if (nt > 8) nt = 8;
    auto ranges = split_rows(sec, n, nt);
    int64_t total = 0;
    std::vector<int64_t> base(ranges.size());
    for (size_t i = 0; i < ranges.size(); i++) {
        base[i] = total; total += ranges[i].rows;
    }
    if (total == 0) return -1;
    struct Per {   // per-thread results
        // string_views into `sec`, which outlives every map/table here —
        // a std::string per row cost ~3.7M allocations at 3M levels
        std::vector<std::string_view> loci;      // local intern table
        std::vector<uint8_t> lab;                // local label blob
        int64_t rows = 0;
    };
    std::vector<Per> per(ranges.size());
    int64_t* o_fr = (int64_t*)malloc(sizeof(int64_t) * total);
    int64_t* o_to = (int64_t*)malloc(sizeof(int64_t) * total);
    uint8_t* o_cc = (uint8_t*)malloc(total);
    int32_t* o_lc = (int32_t*)malloc(sizeof(int32_t) * total);  // local ids
    uint8_t* o_pg = (uint8_t*)malloc(total);
    int64_t* lab_len_row = (int64_t*)malloc(sizeof(int64_t) * total);
    if (!o_fr || !o_to || !o_cc || !o_lc || !o_pg || !lab_len_row) {
        free(o_fr); free(o_to); free(o_cc); free(o_lc); free(o_pg);
        free(lab_len_row);
        return -1;
    }
    std::atomic<int> bad{0};
    std::vector<std::thread> th;
    for (size_t t = 0; t < ranges.size(); t++) th.emplace_back([&, t]() {
        InternTable intern;
        intern.reserve_names((size_t)(ranges[t].rows > 16
                                      ? ranges[t].rows : 16));
        Per& P = per[t];
        int64_t p = ranges[t].lo, row = base[t];
        const int64_t hi = ranges[t].hi;
        int64_t f_lo, f_hi; bool row_end;
        std::string_view prev_loc;
        int32_t prev_lid = -1;
        while (p < hi && !bad.load(std::memory_order_relaxed)) {
            // f0: edge id (unused)
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (f_lo == f_hi && row_end) continue;     // blank line
            if (row_end) { bad = 1; return; }
            // f1: locus
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (row_end) { bad = 1; return; }
            std::string_view loc((const char*)sec + f_lo,
                                 (size_t)(f_hi - f_lo));
            // edges of one level are adjacent: run fast path skips the
            // table for the repeat rows
            int32_t lid;
            if (prev_lid >= 0 && loc == prev_loc) lid = prev_lid;
            else lid = intern.intern(loc);
            prev_loc = loc; prev_lid = lid;
            o_lc[row] = lid;
            // f2: unused
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (row_end) { bad = 1; return; }
            // f3: code char (must be exactly 1 byte)
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (row_end || f_hi - f_lo != 1) { bad = 1; return; }
            o_cc[row] = sec[f_lo];
            // f4: from
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (row_end || !parse_i64(sec + f_lo, sec + f_hi,
                                      &o_fr[row])) { bad = 1; return; }
            // f5: to (may be last field: 6-col row)
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (!parse_i64(sec + f_lo, sec + f_hi, &o_to[row])) {
                bad = 1; return;
            }
            if (row_end) {          // 6-field row: label "", pgf 0
                lab_len_row[row] = 0;
                o_pg[row] = 0;
                row++;
                continue;
            }
            // f6: label
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (row_end) { bad = 1; return; }
            lab_len_row[row] = f_hi - f_lo;
            P.lab.insert(P.lab.end(), sec + f_lo, sec + f_hi);
            // f7: pgf flag (must end the row)
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (!row_end) { bad = 1; return; }
            o_pg[row] = flag_of(sec + f_lo, sec + f_hi);
            row++;
        }
        if (!bad.load()) {
            P.loci = std::move(intern.names);
            P.rows = row - base[t];
            for (int64_t r = row; r < base[t] + ranges[t].rows; r++)
                o_fr[r] = INT64_MIN;
        }
    });
    for (auto& x : th) x.join();
    if (bad.load()) {
        free(o_fr); free(o_to); free(o_cc); free(o_lc); free(o_pg);
        free(lab_len_row);
        return -1;
    }
    // merge per-thread locus tables into a global one (first occurrence
    // in FILE order = thread order, local order within a thread)
    InternTable gtab;
    size_t tot_loc = 0;
    for (auto& P : per) tot_loc += P.loci.size();
    gtab.reserve_names(tot_loc > 16 ? tot_loc : 16);
    std::vector<std::vector<int32_t>> remap(ranges.size());
    for (size_t t = 0; t < ranges.size(); t++) {
        remap[t].resize(per[t].loci.size());
        for (size_t i = 0; i < per[t].loci.size(); i++)
            remap[t][i] = gtab.intern(per[t].loci[i]);
    }
    std::vector<std::string_view>& gnames = gtab.names;
    // compact blank-line slots + apply locus remap + build label offsets
    int64_t w = 0, lab_total = 0;
    for (size_t t = 0; t < ranges.size(); t++)
        lab_total += (int64_t)per[t].lab.size();
    uint8_t* lab_blob = (uint8_t*)malloc(lab_total ? lab_total : 1);
    int64_t* lab_off = (int64_t*)malloc(sizeof(int64_t) * (total + 1));
    if (!lab_blob || !lab_off) {
        free(o_fr); free(o_to); free(o_cc); free(o_lc); free(o_pg);
        free(lab_len_row); free(lab_blob); free(lab_off);
        return -1;
    }
    int64_t lab_w = 0;
    lab_off[0] = 0;
    for (size_t t = 0; t < ranges.size(); t++) {
        const uint8_t* lb = per[t].lab.data();
        int64_t lb_pos = 0;
        for (int64_t r = base[t]; r < base[t] + ranges[t].rows; r++) {
            if (o_fr[r] == INT64_MIN) continue;
            o_fr[w] = o_fr[r]; o_to[w] = o_to[r]; o_cc[w] = o_cc[r];
            o_pg[w] = o_pg[r];
            o_lc[w] = remap[t][o_lc[r]];
            int64_t ll = lab_len_row[r];
            memcpy(lab_blob + lab_w, lb + lb_pos, (size_t)ll);
            lb_pos += ll; lab_w += ll;
            lab_off[w + 1] = lab_w;
            w++;
        }
    }
    free(lab_len_row);
    // locus name blob
    int64_t loc_total = 0;
    for (auto& s : gnames) loc_total += (int64_t)s.size();
    uint8_t* loc_blob = (uint8_t*)malloc(loc_total ? loc_total : 1);
    int64_t* loc_off = (int64_t*)malloc(sizeof(int64_t)
                                        * (gnames.size() + 1));
    if (!loc_blob || !loc_off) {
        free(o_fr); free(o_to); free(o_cc); free(o_lc); free(o_pg);
        free(lab_blob); free(lab_off); free(loc_blob); free(loc_off);
        return -1;
    }
    int64_t lw = 0;
    loc_off[0] = 0;
    for (size_t i = 0; i < gnames.size(); i++) {
        memcpy(loc_blob + lw, gnames[i].data(), gnames[i].size());
        lw += (int64_t)gnames[i].size();
        loc_off[i + 1] = lw;
    }
    *out_from = o_fr; *out_to = o_to; *out_cc = o_cc; *out_locus = o_lc;
    *out_pgf = o_pg;
    *out_lab_blob = lab_blob; *out_lab_off = lab_off; *out_lab_len = lab_w;
    *out_loc_blob = loc_blob; *out_loc_off = loc_off;
    *out_n_locus = (int64_t)gnames.size();
    return w;
}

// CODE-section parse against a provided locus-name table: rows are
// locus ||| allele ||| code.  Returns row count, -1 on malformed.
// out_fid[i] = index of the locus in the provided (blob, off) table or -1,
// out_code[i] = integer code, out_a0[i] = first byte of the allele,
// out_alen[i] = allele length in bytes.  Caller frees with hla_free.
extern "C" int64_t hla_parse_prg_code(
    const uint8_t* sec, int64_t n, int n_threads,
    const uint8_t* loc_blob, const int64_t* loc_off, int64_t n_locus,
    int64_t** out_fid, int64_t** out_code,
    uint8_t** out_a0, int64_t** out_alen) {
    using namespace prgparse;
    *out_fid = *out_code = *out_alen = nullptr; *out_a0 = nullptr;
    InternTable table;   // flat table: 3M unordered_map nodes cost ~1s
    table.reserve_names((size_t)(n_locus > 16 ? n_locus : 16));
    // duplicate names in the provided table (not produced by our edge
    // parser, but keep exact first-wins semantics): map rank -> first
    // blob index
    std::vector<int64_t> first_idx;
    first_idx.reserve((size_t)n_locus);
    for (int64_t i = 0; i < n_locus; i++) {
        int32_t id = table.intern(std::string_view(
            (const char*)loc_blob + loc_off[i],
            (size_t)(loc_off[i + 1] - loc_off[i])));
        if ((size_t)id == first_idx.size()) first_idx.push_back(i);
    }
    int nt = n_threads > 0 ? n_threads : 1;
    if (nt > 8) nt = 8;
    auto ranges = split_rows(sec, n, nt);
    int64_t total = 0;
    std::vector<int64_t> base(ranges.size());
    for (size_t i = 0; i < ranges.size(); i++) {
        base[i] = total; total += ranges[i].rows;
    }
    int64_t* o_fid = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
    int64_t* o_cd = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
    uint8_t* o_a0 = (uint8_t*)malloc(total ? total : 1);
    int64_t* o_al = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
    if (!o_fid || !o_cd || !o_a0 || !o_al) {
        free(o_fid); free(o_cd); free(o_a0); free(o_al); return -1;
    }
    std::atomic<int> bad{0};
    std::vector<std::thread> th;
    for (size_t t = 0; t < ranges.size(); t++) th.emplace_back([&, t]() {
        int64_t p = ranges[t].lo, row = base[t];
        const int64_t hi = ranges[t].hi;
        int64_t f_lo, f_hi; bool row_end;
        while (p < hi && !bad.load(std::memory_order_relaxed)) {
            // f0: locus
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (f_lo == f_hi && row_end) continue;    // blank line
            if (row_end) { bad = 1; return; }
            int32_t rk = table.find(std::string_view(
                (const char*)sec + f_lo, (size_t)(f_hi - f_lo)));
            o_fid[row] = rk < 0 ? -1 : first_idx[rk];
            // f1: allele
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (row_end) { bad = 1; return; }
            o_a0[row] = (f_hi > f_lo) ? sec[f_lo] : 0;
            o_al[row] = f_hi - f_lo;
            // f2: code (ends the row)
            next_field(sec, hi, &p, &f_lo, &f_hi, &row_end);
            if (!row_end || !parse_i64(sec + f_lo, sec + f_hi,
                                       &o_cd[row])) { bad = 1; return; }
            row++;
        }
        if (!bad.load())
            for (int64_t r = row; r < base[t] + ranges[t].rows; r++)
                o_fid[r] = INT64_MIN;
    });
    for (auto& x : th) x.join();
    if (bad.load()) {
        free(o_fid); free(o_cd); free(o_a0); free(o_al); return -1;
    }
    int64_t w = 0;
    for (int64_t r = 0; r < total; r++) {
        if (o_fid[r] == INT64_MIN) continue;
        if (w != r) { o_fid[w] = o_fid[r]; o_cd[w] = o_cd[r];
                      o_a0[w] = o_a0[r]; o_al[w] = o_al[r]; }
        w++;
    }
    *out_fid = o_fid; *out_code = o_cd; *out_a0 = o_a0; *out_alen = o_al;
    return w;
}

// ---------------------------------------------------------------------------
// Read-tensor build (typer._build_read_tensors hot loop; the matmul
// lowering of HLATyper.cpp:2089-2276): per observation, write the 6
// contribution + 6 mismatch channel cells.  All float math is table
// lookups precomputed by the caller in numpy (per-genotype and per-quality
// f64 tables) + one f64 add + f32 cast — bit-identical to the numpy
// scatter path.  (r, j) is unique per obs, so threads over obs ranges
// write disjoint cells.
// ---------------------------------------------------------------------------
extern "C" void hla_build_read_tensors(
    const int64_t* r_idx, const int64_t* j_idx, const int64_t* gid,
    const uint8_t* q0, int64_t n_obs,
    const uint8_t* gap_tbl, const int8_t* chf_tbl, const uint8_t* sing_tbl,
    const double* tail_tbl, const double* chgap_tbl,
    const double* vmatch_q, const double* vmis_q, double log_del,
    int64_t R, int64_t J, int transposed,
    float* contrib, float* mismatch, int n_threads) {
    int nt = n_threads > 0 ? n_threads : 1;
    if (nt > 8) nt = 8;
    int64_t chunk = (n_obs + nt - 1) / nt;
    auto work = [&](int t) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < n_obs ? lo + chunk : n_obs;
        for (int64_t i = lo; i < hi; i++) {
            int64_t g = gid[i];
            int q = q0[i];
            bool is_gap = gap_tbl[g] != 0;
            int ch1 = chf_tbl[g];
            double vm, vs;
            if (is_gap) { vm = log_del; vs = log_del; }
            else { vm = vmatch_q[q]; vs = vmis_q[q]; }
            double tail = tail_tbl[g];
            float c_other = (float)(vs + tail);
            float c_match = (float)(vm + tail);
            float c_gap = is_gap ? 0.0f : (float)chgap_tbl[g];
            float m_base = is_gap ? 0.0f : 1.0f;
            bool single = sing_tbl[g] != 0;
            int64_t r = r_idx[i], j = j_idx[i];
            float* c;
            float* m;
            int64_t stride;          // per-channel step
            if (transposed) {        // [J*6, R]: cell = (j*6+ch)*R + r
                c = contrib + j * 6 * R + r;
                m = mismatch + j * 6 * R + r;
                stride = R;
            } else {                 // [R, J, 6]: cell = (r*J+j)*6 + ch
                c = contrib + (r * J + j) * 6;
                m = mismatch + (r * J + j) * 6;
                stride = 1;
            }
            for (int ch = 0; ch < 4; ch++) {
                bool hit = (ch == ch1) && !is_gap;
                c[ch * stride] = hit ? c_match : c_other;
                m[ch * stride] = (!is_gap && !(single && ch == ch1))
                                 ? 1.0f : 0.0f;
            }
            c[4 * stride] = c_gap;            // CH_GAP
            m[4 * stride] = m_base;
            c[5 * stride] = c_other;          // CH_OTHER
            m[5 * stride] = m_base;
        }
    };
    if (nt == 1) { work(0); return; }
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Per-chain record build (typer._chain_records; the column walk of
// HLATyper.cpp:3192-3566 done once per chain): record columns are the
// level-bearing columns; trailing insertion columns fold into the record.
// Interning uses the caller's 256-entry LUTs; any unseen byte or any
// record with trailing insertions that needs a multi-byte intern is
// reported back (return -1 = unseen byte: caller uses its python path for
// this chain, preserving intern-table order; insertion records are
// returned via out_ins_idx for the caller's rare-case loop).
// Returns n_rec, or -1.
// ---------------------------------------------------------------------------
extern "C" int64_t hla_chain_record(
    const uint8_t* seq_c, const uint8_t* graph_c, const int64_t* levels,
    const uint8_t* qual, const double* mq,      // mq may be NULL (-> 1.0)
    int64_t n_cols,
    const int64_t* lut_g, const int64_t* lut_q, int64_t qid_empty,
    int64_t* out_levels, uint8_t* out_worst, int64_t* out_gid,
    int64_t* out_qid, int64_t* out_q0, double* out_mqp,
    int64_t* out_runnovel, int64_t* out_cols_nongap,
    int64_t* out_ins_idx, int64_t* out_n_ins) {
    const uint8_t GAPB = (uint8_t)'_';
    // forward/backward running-novel-gap lengths
    std::vector<int64_t> fwd((size_t)n_cols), bwd((size_t)n_cols);
    {
        int64_t cs = 0, base = 0;
        for (int64_t i = 0; i < n_cols; i++) {
            bool sg = seq_c[i] == GAPB, gg = graph_c[i] == GAPB;
            bool reset = !sg && !gg;
            bool novel = !reset && !(sg && gg);
            cs += novel ? 1 : 0;
            int64_t v = reset ? cs : 0;
            if (v > base) base = v;
            fwd[(size_t)i] = cs - base;
        }
        cs = 0; base = 0;
        for (int64_t i = n_cols - 1; i >= 0; i--) {
            bool sg = seq_c[i] == GAPB, gg = graph_c[i] == GAPB;
            bool reset = !sg && !gg;
            bool novel = !reset && !(sg && gg);
            cs += novel ? 1 : 0;
            int64_t v = reset ? cs : 0;
            if (v > base) base = v;
            bwd[(size_t)i] = cs - base;
        }
    }
    int64_t nongap = 0;
    for (int64_t i = 0; i < n_cols; i++)
        if (seq_c[i] != GAPB) nongap++;
    *out_cols_nongap = nongap;
    // records + interning (exact python order: every record's single-byte
    // lookups happen before the insertion overrides)
    int64_t n_rec = 0, n_ins_rec = 0;
    int64_t i = 0;
    while (i < n_cols) {
        if (levels[i] < 0) { i++; continue; }
        int64_t nxt = i + 1;
        while (nxt < n_cols && levels[nxt] < 0) nxt++;
        int64_t n_ins = nxt - i - 1;
        bool is_del = seq_c[i] == GAPB;
        int64_t g = lut_g[seq_c[i]];
        int64_t q = lut_q[qual[i]];
        if (g < 0 || q < 0) return -1;        // unseen byte: python path
        out_levels[n_rec] = levels[i];
        out_gid[n_rec] = g;
        out_qid[n_rec] = is_del ? qid_empty : q;
        out_q0[n_rec] = is_del ? 0 : (int64_t)qual[i];
        out_worst[n_rec] = is_del ? 0 : qual[i];
        out_mqp[n_rec] = mq ? mq[i] : 1.0;
        out_runnovel[n_rec] = fwd[(size_t)i] > bwd[(size_t)i]
                              ? fwd[(size_t)i] : bwd[(size_t)i];
        if (n_ins > 0) {
            // caller's python loop interns the multi-byte genotype/qual
            // and overrides gid/qid/q0/worst for these records
            out_ins_idx[n_ins_rec++] = n_rec;
        }
        n_rec++;
        i = nxt;
    }
    *out_n_ins = n_ins_rec;
    return n_rec;
}
