// lz4core: native host engine for the lz4tpu LZ4 codec.
//
// This is the CPU side of the framework: the parts of the codec that are
// control-flow heavy and byte-granular (token scanning, streaming-mode ring
// decode, xxhash32, hash-chain match finding) run here at native speed; the
// bandwidth-heavy bulk work (byte-parallel decode, batched checksums)
// runs on the GPU via XLA and Pallas (see lz4tpu/device/).
//
// Behavioral parity targets (reference file:line, /root/reference):
//   - block sequence grammar: lib/lz4ada.adb:716-788
//   - ring/history semantics:  lib/lz4ada.adb:678-680, 845-904
//   - xxhash32:                lib/lz4ada.adb:923-1026
//
// All functions use a plain C ABI and are loaded from Python via ctypes.
// Error reporting: non-zero status codes; the Python layer re-runs failing
// inputs through the exact-message oracle to produce contract-parity
// diagnostics, so only *which* check failed matters here, plus enough
// detail for fast paths.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// xxhash32
// ---------------------------------------------------------------------------

static const uint32_t P1 = 2654435761u;
static const uint32_t P2 = 2246822519u;
static const uint32_t P3 = 3266489917u;
static const uint32_t P4 = 668265263u;
static const uint32_t P5 = 374761393u;

static inline uint32_t rotl32(uint32_t v, int r) {
    return (v << r) | (v >> (32 - r));
}

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;  // little-endian hosts only, like the reference
}

static inline uint64_t read64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

// Extend a match [cand, ip) forward up to maxl bytes, 8 at a time.
static inline int64_t extend_match(const uint8_t* base, int64_t cand,
                                   int64_t ip, int64_t from, int64_t maxl) {
    int64_t l = from;
    while (l + 8 <= maxl && read64(base + cand + l) == read64(base + ip + l))
        l += 8;
    while (l < maxl && base[cand + l] == base[ip + l]) ++l;
    return l;
}

typedef struct {
    uint32_t s0, s1, s2, s3;
    uint64_t total;
    uint32_t buf_size;
    uint8_t buf[16];
} xxh32_state;

void lz4tpu_xxh32_init(xxh32_state* st, uint32_t seed) {
    st->s0 = seed + P1 + P2;
    st->s1 = seed + P2;
    st->s2 = seed;
    st->s3 = seed - P1;
    st->total = 0;
    st->buf_size = 0;
}

void lz4tpu_xxh32_update(xxh32_state* st, const uint8_t* data, int64_t n) {
    st->total += (uint64_t)n;
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    if (st->buf_size) {
        while (st->buf_size < 16 && p < end) st->buf[st->buf_size++] = *p++;
        if (st->buf_size < 16) return;
        st->s0 = rotl32(st->s0 + read32(st->buf + 0) * P2, 13) * P1;
        st->s1 = rotl32(st->s1 + read32(st->buf + 4) * P2, 13) * P1;
        st->s2 = rotl32(st->s2 + read32(st->buf + 8) * P2, 13) * P1;
        st->s3 = rotl32(st->s3 + read32(st->buf + 12) * P2, 13) * P1;
        st->buf_size = 0;
    }
    uint32_t s0 = st->s0, s1 = st->s1, s2 = st->s2, s3 = st->s3;
    while (end - p >= 16) {
        s0 = rotl32(s0 + read32(p + 0) * P2, 13) * P1;
        s1 = rotl32(s1 + read32(p + 4) * P2, 13) * P1;
        s2 = rotl32(s2 + read32(p + 8) * P2, 13) * P1;
        s3 = rotl32(s3 + read32(p + 12) * P2, 13) * P1;
        p += 16;
    }
    st->s0 = s0; st->s1 = s1; st->s2 = s2; st->s3 = s3;
    while (p < end) st->buf[st->buf_size++] = *p++;
}

uint32_t lz4tpu_xxh32_final(const xxh32_state* st) {
    uint32_t h;
    if (st->total >= 16) {
        h = rotl32(st->s0, 1) + rotl32(st->s1, 7) + rotl32(st->s2, 12) +
            rotl32(st->s3, 18);
    } else {
        h = st->s2 + P5;
    }
    h += (uint32_t)st->total;
    uint32_t i = 0;
    while (i + 4 <= st->buf_size) {
        h = rotl32(h + read32(st->buf + i) * P3, 17) * P4;
        i += 4;
    }
    while (i < st->buf_size) {
        h = rotl32(h + st->buf[i] * P5, 11) * P1;
        i += 1;
    }
    h ^= h >> 15; h *= P2;
    h ^= h >> 13; h *= P3;
    h ^= h >> 16;
    return h;
}

uint32_t lz4tpu_xxh32(const uint8_t* data, int64_t n, uint32_t seed) {
    xxh32_state st;
    lz4tpu_xxh32_init(&st, seed);
    lz4tpu_xxh32_update(&st, data, n);
    return lz4tpu_xxh32_final(&st);
}

int32_t lz4tpu_xxh32_state_size(void) { return (int32_t)sizeof(xxh32_state); }

// ---------------------------------------------------------------------------
// Block decode (ring semantics identical to the reference streaming core)
// ---------------------------------------------------------------------------

enum {
    LZ4TPU_OK = 0,
    LZ4TPU_E_OFFSET_ZERO = 1,      // err_a = (unused)
    LZ4TPU_E_BACKREF_RANGE = 2,    // err_a = h_offset (negative)
    LZ4TPU_E_MATCH_AFTER_LIT = 3,  // err_a = match nibble
    LZ4TPU_E_TRUNCATED = 4,        // sequence ran past end of block input
    LZ4TPU_E_DST_OVERFLOW = 5,     // output exceeded dst capacity
    LZ4TPU_E_SEQ_OVERFLOW = 6,     // sequence table capacity exceeded
};

// Read a 255-chained variable length extension. Returns -1 on truncation.
static inline int64_t var_length(const uint8_t* src, int64_t n, int64_t* ip,
                                 int64_t base) {
    int64_t v = base;
    if (base == 15) {
        uint8_t b;
        do {
            if (*ip >= n) return -1;
            b = src[*ip];
            *ip += 1;
            v += b;
        } while (b == 255);
    }
    return v;
}

// Decode one raw LZ4 block into `buf` at position `out_pos`, with the
// reference's wrapped-ring back-reference semantics:
//   raw = out_pos - offset; raw >= 0 reads buf[raw], raw < 0 reads
//   buf[raw + out_pos_history] (the retained previous region).
// Writes may run up to 8 bytes past the logical end (wild copy); `buf`
// must have >= 8 bytes of slack beyond `buf_len`... no: buf_len IS the
// allocation; we bound every write instead (branch is off the hot path).
//
// Returns a status code; on success *new_out_pos = out_pos + produced.
// On error, err_a carries the detail (see enum comments).
int32_t lz4tpu_decode_block_ring(
    const uint8_t* src, int64_t src_len,
    uint8_t* buf, int64_t buf_len,
    int64_t out_pos, int64_t out_pos_history,
    int64_t* new_out_pos, int64_t* err_a) {
    int64_t ip = 0;
    int64_t op = out_pos;
    *err_a = 0;
    // Wild copies overshoot the logical write position by up to 15
    // bytes.  In the wrapped-ring regime bytes ahead of `op` ARE the
    // still-reachable history tail (reachable down to
    // out_pos_history - 65535), so overshoot is only safe strictly
    // below that line; with no retained history it is always safe.
    const int64_t wild_end =
        out_pos_history == 0
            ? buf_len
            : (out_pos_history - 65536 - 16 > 0
                   ? out_pos_history - 65536 - 16 : 0);
    // Shortcut guards for the dominant case (unextended token, all
    // reads/writes provably in range): lit <= 14 read as one 16-byte
    // copy, match <= 18 as 18 wild bytes.  Mirrors the structure of
    // the reference's hot loop with its suppressed checks
    // (lz4ada.adb:798-817) but gated to provably-safe regions.
    const int64_t ip_fast = src_len - 32;
    const int64_t op_fast = (wild_end < buf_len ? wild_end : buf_len) - 64;
    while (ip < src_len) {
        const uint8_t token = src[ip++];
        if (token < 0xF0 && (token & 0x0F) != 0x0F
            && ip < ip_fast && op < op_fast) {
            const int64_t litf = token >> 4;
            std::memcpy(buf + op, src + ip, 16);
            ip += litf;
            op += litf;
            const int64_t offset =
                (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
            ip += 2;
            if (offset == 0) return LZ4TPU_E_OFFSET_ZERO;
            const int64_t raw = op - offset;
            if (raw >= 0 && offset >= 18) {
                std::memcpy(buf + op, buf + raw, 18);
                op += (token & 0x0F) + 4;
                continue;
            }
            if (raw >= 0 && offset >= 8) {
                std::memcpy(buf + op, buf + raw, 8);
                std::memcpy(buf + op + 8, buf + raw + 8, 8);
                std::memcpy(buf + op + 16, buf + raw + 16, 2);
                op += (token & 0x0F) + 4;
                continue;
            }
            // small offset or history reach: generic match copy below
            int64_t mlen = (token & 0x0F) + 4;
            int64_t remaining = mlen;
            int64_t raw2 = raw;
            if (raw2 < 0) {
                const int64_t h_off = raw2 + out_pos_history;
                if (h_off < 0) {
                    *err_a = h_off;
                    return LZ4TPU_E_BACKREF_RANGE;
                }
                int64_t h_len = -raw2;
                if (h_len > remaining) h_len = remaining;
                std::memcpy(buf + op, buf + h_off, (size_t)h_len);
                op += h_len;
                remaining -= h_len;
                raw2 = 0;
            }
            while (remaining > 0) {
                int64_t chunk = op - raw2;
                if (chunk > remaining) chunk = remaining;
                std::memcpy(buf + op, buf + raw2, (size_t)chunk);
                op += chunk;
                remaining -= chunk;
            }
            continue;
        }
        int64_t lit = var_length(src, src_len, &ip, token >> 4);
        if (lit < 0) return LZ4TPU_E_TRUNCATED;
        if (ip + lit > src_len) {
            // Overlong literal run: the reference fails this at the
            // match-nibble check (lz4ada.adb:752-764); mirror that.
            if (token & 0x0F) {
                *err_a = token & 0x0F;
                return LZ4TPU_E_MATCH_AFTER_LIT;
            }
            return LZ4TPU_E_TRUNCATED;
        }
        if (lit > 0) {
            if (op + lit > buf_len) return LZ4TPU_E_DST_OVERFLOW;
            if (lit <= 16 && ip + 16 <= src_len && op + 16 <= buf_len
                && op + 16 <= wild_end) {
                // wild copy (reference: suppressed-check Write_Output,
                // lz4ada.adb:798-817): the buffer carries +8 slack and
                // short literal runs dominate text streams
                std::memcpy(buf + op, src + ip, 16);
            } else {
                std::memcpy(buf + op, src + ip, (size_t)lit);
            }
            ip += lit;
            op += lit;
        }
        if (ip >= src_len) {
            if ((token & 0x0F) != 0) {
                *err_a = token & 0x0F;
                return LZ4TPU_E_MATCH_AFTER_LIT;
            }
            break;
        }
        if (ip + 2 > src_len) return LZ4TPU_E_TRUNCATED;
        const int64_t offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
        ip += 2;
        if (offset == 0) return LZ4TPU_E_OFFSET_ZERO;
        int64_t mlen = var_length(src, src_len, &ip, token & 0x0F);
        if (mlen < 0) return LZ4TPU_E_TRUNCATED;
        mlen += 4;
        if (op + mlen > buf_len) return LZ4TPU_E_DST_OVERFLOW;

        int64_t raw = op - offset;
        int64_t remaining = mlen;
        if (raw < 0) {
            // Part replayed from the retained history region.
            const int64_t h_off = raw + out_pos_history;
            if (h_off < 0) {
                *err_a = h_off;
                return LZ4TPU_E_BACKREF_RANGE;
            }
            int64_t h_len = offset - op;  // == -raw
            if (h_len > remaining) h_len = remaining;
            std::memcpy(buf + op, buf + h_off, (size_t)h_len);
            op += h_len;
            remaining -= h_len;
            raw = 0;
        }
        if (remaining > 0 && op - raw >= 8
            && op + remaining + 8 <= buf_len
            && op + remaining + 8 <= wild_end) {
            // Wild 8-byte strides: write - read distance >= 8, so each
            // chunk never overlaps its own source, and later chunks see
            // earlier writes (correct overlap replication).
            uint8_t* d = buf + op;
            const uint8_t* s2 = buf + raw;
            int64_t n = remaining;
            op += remaining;
            remaining = 0;
            do {
                std::memcpy(d, s2, 8);
                d += 8;
                s2 += 8;
                n -= 8;
            } while (n > 0);
        }
        if (remaining > 0) {
            // Copy from [raw, op); self-overlapping when offset < length.
            int64_t dist = op - raw;
            while (remaining >= dist && dist <= 32) {
                // Double the replay window until wide enough for memcpy.
                std::memcpy(buf + op, buf + raw, (size_t)dist);
                op += dist;
                remaining -= dist;
                dist <<= 1;
            }
            while (remaining > 0) {
                int64_t chunk = op - raw;
                if (chunk > remaining) chunk = remaining;
                std::memcpy(buf + op, buf + raw, (size_t)chunk);
                op += chunk;
                remaining -= chunk;
                raw += 0;  // window origin fixed; span [raw, old op) grows
            }
        }
    }
    *new_out_pos = op;
    return LZ4TPU_OK;
}

// ---------------------------------------------------------------------------
// Sequence scan: token grammar -> flat sequence table (device pass 1)
// ---------------------------------------------------------------------------

// Scans one raw block and appends sequences as structure-of-arrays.
// For sequence s:
//   out_start[s] global output position of the sequence (out_base +
//                bytes decoded so far in this block)
//   lit_len[s]   number of literal bytes
//   lit_src[s]   offset of those literals: position inside `src` plus
//                `lit_base` (the block's offset in the whole stream)
//   match_len[s] match length (0 for a trailing literal-only sequence)
//   match_off[s] back-reference distance (undefined when match_len == 0)
// Returns the number of sequences, or -status on malformed input.
// *total_out accumulates the decoded size of the block; *min_reach the
// lowest global position any back-reference touches (INT64_MAX when
// the block has no matches) — callers compare it against the frame
// start (reference H_Offset < 0 check, lz4ada.adb:867-874) and the
// block start (B.Indep demotion).
int64_t lz4tpu_scan_sequences(
    const uint8_t* src, int64_t src_len,
    int64_t lit_base, int64_t out_base,
    int32_t* out_start, int32_t* lit_len, int32_t* lit_src,
    int32_t* match_len, int32_t* match_off,
    int64_t cap, int64_t* total_out, int64_t* min_reach) {
    int64_t ip = 0;
    int64_t s = 0;
    int64_t out = out_base;
    int64_t reach = INT64_C(0x7FFFFFFFFFFFFFFF);
    while (ip < src_len) {
        if (s >= cap) return -LZ4TPU_E_SEQ_OVERFLOW;
        const uint8_t token = src[ip++];
        int64_t lit = var_length(src, src_len, &ip, token >> 4);
        if (lit < 0) return -LZ4TPU_E_TRUNCATED;
        if (ip + lit > src_len)
            return (token & 0x0F) ? -LZ4TPU_E_MATCH_AFTER_LIT
                                  : -LZ4TPU_E_TRUNCATED;
        out_start[s] = (int32_t)out;
        lit_len[s] = (int32_t)lit;
        lit_src[s] = (int32_t)(ip + lit_base);
        ip += lit;
        out += lit;
        if (ip >= src_len) {
            if ((token & 0x0F) != 0) return -LZ4TPU_E_MATCH_AFTER_LIT;
            match_len[s] = 0;
            match_off[s] = 1;
            ++s;
            break;
        }
        if (ip + 2 > src_len) return -LZ4TPU_E_TRUNCATED;
        const int64_t offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
        ip += 2;
        if (offset == 0) return -LZ4TPU_E_OFFSET_ZERO;
        int64_t mlen = var_length(src, src_len, &ip, token & 0x0F);
        if (mlen < 0) return -LZ4TPU_E_TRUNCATED;
        mlen += 4;
        if (out - offset < reach) reach = out - offset;
        match_len[s] = (int32_t)mlen;
        match_off[s] = (int32_t)offset;
        out += mlen;
        ++s;
    }
    *total_out = out - out_base;
    *min_reach = reach;
    return s;
}

// Single-block "full" scan: lz4tpu_scan_sequences plus, in the same
// pass, the cumulative literal position column (litpos), the flat
// literal-stream extraction (the compressed bytes are cache-hot at
// parse time — cf. the prep's Write_Output-style wild copies), and
// the S/S+1 sentinel slots on starts/litpos that the fused prep's
// bisects need.  Error detection order is byte-identical to
// lz4tpu_scan_sequences (same checks, same sequence positions), so
// the single-block fast path reports the same malformed-input status
// as the generic path.  Feeds lz4tpu_prep_fused_pre, which skips its
// phase-1 (prefix sums + literal extraction) entirely.
int64_t lz4tpu_scan_block_full(
    const uint8_t* src, int64_t src_len, int64_t lit_base,
    int32_t* out_start,   // [cap + 2] (sentinels at [s], [s+1])
    int32_t* lit_len, int32_t* lit_src,
    int32_t* match_len, int32_t* match_off,
    int32_t* litpos,      // [cap + 2] (sentinels at [s], [s+1])
    uint8_t* lits, int64_t lits_cap,
    int64_t cap, int64_t* total_out, int64_t* min_reach,
    int64_t* n_lit_out, int64_t* max_off_out) {
    int64_t ip = 0;
    int64_t s = 0;
    int64_t out = 0;
    int64_t lp = 0;
    int64_t max_off = 1;
    int64_t reach = INT64_C(0x7FFFFFFFFFFFFFFF);
    while (ip < src_len) {
        if (s >= cap) return -LZ4TPU_E_SEQ_OVERFLOW;
        const uint8_t token = src[ip++];
        int64_t lit = var_length(src, src_len, &ip, token >> 4);
        if (lit < 0) return -LZ4TPU_E_TRUNCATED;
        if (ip + lit > src_len)
            return (token & 0x0F) ? -LZ4TPU_E_MATCH_AFTER_LIT
                                  : -LZ4TPU_E_TRUNCATED;
        out_start[s] = (int32_t)out;
        lit_len[s] = (int32_t)lit;
        lit_src[s] = (int32_t)(ip + lit_base);
        litpos[s] = (int32_t)lp;
        if (lit <= 16 && ip + 16 <= src_len && lp + 16 <= lits_cap) {
            memcpy(lits + lp, src + ip, 16);   // wild copy; next run
                                               // overwrites the spill
        } else if (lit) {
            if (lp + lit > lits_cap) return -LZ4TPU_E_SEQ_OVERFLOW;
            memcpy(lits + lp, src + ip, (size_t)lit);
        }
        lp += lit;
        ip += lit;
        out += lit;
        if (ip >= src_len) {
            if ((token & 0x0F) != 0) return -LZ4TPU_E_MATCH_AFTER_LIT;
            match_len[s] = 0;
            match_off[s] = 1;
            ++s;
            break;
        }
        if (ip + 2 > src_len) return -LZ4TPU_E_TRUNCATED;
        const int64_t offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
        ip += 2;
        if (offset == 0) return -LZ4TPU_E_OFFSET_ZERO;
        int64_t mlen = var_length(src, src_len, &ip, token & 0x0F);
        if (mlen < 0) return -LZ4TPU_E_TRUNCATED;
        mlen += 4;
        if (out - offset < reach) reach = out - offset;
        if (offset > max_off) max_off = offset;
        match_len[s] = (int32_t)mlen;
        match_off[s] = (int32_t)offset;
        out += mlen;
        ++s;
    }
    if (out >= INT64_C(0x7FFFFFF0) || lp >= INT64_C(0x7FFFFFF0))
        return -LZ4TPU_E_SEQ_OVERFLOW;
    out_start[s] = (int32_t)out;
    out_start[s + 1] = INT32_C(0x7FFFFFFF);
    litpos[s] = (int32_t)lp;
    litpos[s + 1] = (int32_t)lp;
    *total_out = out;
    *min_reach = reach;
    *n_lit_out = lp;
    *max_off_out = max_off;
    return s;
}

// ---------------------------------------------------------------------------
// Encoder: greedy hash-chain match finder producing standard LZ4 blocks
// ---------------------------------------------------------------------------

static inline uint32_t hash_seq(uint32_t v) {
    return (v * 2654435761u) >> (32 - 16);  // 16-bit hash table
}

// Compress one block. `hist` may point at up to 64 KiB of preceding
// output (linked blocks); pass hist_len = 0 for independent blocks.
// Returns compressed size, or -1 if it would exceed dst capacity, or 0
// for an empty input.
int64_t lz4tpu_compress_block(
    const uint8_t* hist, int64_t hist_len,
    const uint8_t* src, int64_t src_len,
    uint8_t* dst, int64_t dst_cap,
    int32_t max_chain, int32_t lazy) {
    if (src_len <= 0) return 0;

    // Work over a virtual stream: positions [0, hist_len) are history,
    // [hist_len, hist_len + src_len) are the bytes to encode.
    // We require hist to be contiguous with src when hist_len > 0
    // (callers pass a window into one buffer); otherwise hist_len == 0.
    const uint8_t* base = (hist_len > 0) ? hist : src;
    const int64_t start = hist_len;               // first pos to encode
    const int64_t end = hist_len + src_len;        // one past last

    static const int HASH_SIZE = 1 << 16;
    // Per-call tables: head[h] = most recent position + 1 (0 = empty),
    // chain[pos & 0xFFFF] links to the previous position with same hash.
    // Window is 64 KiB so a 64 Ki chain ring suffices.
    int64_t* head = new int64_t[HASH_SIZE];
    int64_t* chain = new int64_t[1 << 16];
    std::memset(head, 0, HASH_SIZE * sizeof(int64_t));
    std::memset(chain, 0, (1 << 16) * sizeof(int64_t));

    const int64_t MFLIMIT = 12;   // last 12 bytes are always literals
    const int64_t MINMATCH = 4;
    int64_t ip = start;
    int64_t anchor = start;
    int64_t op = 0;
    const int64_t match_limit = end - 5;  // last match must start 12 from end

    // Seed the tables with history positions so linked blocks can match
    // into the previous 64 KiB.
    for (int64_t p = (hist_len > (int64_t)0xFFFF ? hist_len - 0xFFFF : 0);
         hist_len > 0 && p + MINMATCH <= hist_len; ++p) {
        uint32_t h = hash_seq(read32(base + p));
        chain[p & 0xFFFF] = head[h];
        head[h] = p + 1;
    }

    #define EMIT_FAIL { delete[] head; delete[] chain; return -1; }

    // Search the hash chain for the longest match at position p.
    // Inserts p into the tables as a side effect.
    int64_t last_inserted = -1;  // highest position added to the tables
    auto find_match = [&](int64_t p, int64_t* pos_out) -> int64_t {
        last_inserted = p;
        uint32_t h = hash_seq(read32(base + p));
        int64_t best_len = 0;
        int64_t cand = head[h] - 1;
        int tries = max_chain;
        const int64_t maxl = match_limit - p;
        while (cand >= 0 && cand + 0xFFFF >= p && tries-- > 0) {
            // one-byte pre-test: a candidate that cannot beat best_len
            // differs at position best_len; rejects most of the chain
            // on repetitive data with a single load
            if (cand < p
                && (best_len == 0 || base[cand + best_len] == base[p + best_len])
                && read32(base + cand) == read32(base + p)) {
                int64_t l = MINMATCH;
                while (l < maxl && base[cand + l] == base[p + l]) ++l;
                if (l >= MINMATCH && l > best_len) {
                    best_len = l;
                    *pos_out = cand;
                }
                if (best_len >= maxl) break;  // cannot improve
            }
            int64_t next = chain[cand & 0xFFFF] - 1;
            if (next >= cand) break;  // stale ring entry: stop the walk
            cand = next;
        }
        chain[p & 0xFFFF] = head[h];
        head[h] = p + 1;
        return best_len;
    };

    // Skip acceleration (the classic LZ4 fast-path trade): after ~64
    // consecutive miss positions the stride between attempted
    // positions grows, so incompressible regions cost O(n/step)
    // searches instead of O(n). Skipped positions are not inserted —
    // a deliberate ratio-for-speed trade reset on every found match.
    int64_t search_count = 1 << 6;
    while (ip + MFLIMIT <= end) {
        int64_t best_pos = -1;
        int64_t best_len = find_match(ip, &best_pos);
        if (best_len < MINMATCH) {
            ip += search_count++ >> 6;
            continue;
        }
        search_count = 1 << 6;

        // Lazy evaluation: a longer match starting one byte later wins
        // (repeat while it keeps improving).
        while (lazy && ip + 1 + MFLIMIT <= end) {
            int64_t pos1 = -1;
            int64_t len1 = find_match(ip + 1, &pos1);
            if (len1 > best_len + 1) {
                best_len = len1;
                best_pos = pos1;
                ++ip;
            } else {
                break;
            }
        }

        // Extend the match backwards over pending literals.
        while (ip > anchor && best_pos > 0 &&
               base[best_pos - 1] == base[ip - 1]) {
            --ip;
            --best_pos;
            ++best_len;
        }

        // Emit sequence: literals [anchor, ip) + match (best_pos, best_len).
        const int64_t lit = ip - anchor;
        const int64_t offset = ip - best_pos;
        int64_t mtoken = best_len - MINMATCH;
        // token + worst-case length extensions + literals + offset
        if (op + 1 + lit / 255 + 1 + lit + 2 + mtoken / 255 + 1 > dst_cap)
            EMIT_FAIL;
        uint8_t* tok = dst + op++;
        *tok = 0;
        if (lit >= 15) {
            *tok = 15 << 4;
            int64_t rest = lit - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok = (uint8_t)(lit << 4);
        }
        std::memcpy(dst + op, base + anchor, (size_t)lit);
        op += lit;
        dst[op++] = (uint8_t)(offset & 0xFF);
        dst[op++] = (uint8_t)(offset >> 8);
        if (mtoken >= 15) {
            *tok |= 15;
            int64_t rest = mtoken - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok |= (uint8_t)mtoken;
        }

        // Insert skipped positions into the chain (stride for speed on
        // very long matches; dense elsewhere for ratio). Positions up to
        // last_inserted are already in the tables — re-inserting one
        // would self-loop its chain entry.
        const int64_t insert_end = ip + best_len;
        int64_t step = best_len >= 65536 ? 16 : 1;
        for (int64_t p = last_inserted + 1;
             p < insert_end && p + MINMATCH <= end; p += step) {
            uint32_t hh = hash_seq(read32(base + p));
            chain[p & 0xFFFF] = head[hh];
            head[hh] = p + 1;
            last_inserted = p;
        }
        ip += best_len;
        anchor = ip;
    }

    // Final literals.
    {
        const int64_t lit = end - anchor;
        if (op + 1 + lit / 255 + 1 + lit > dst_cap) EMIT_FAIL;
        if (lit >= 15) {
            dst[op++] = 15 << 4;
            int64_t rest = lit - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            dst[op++] = (uint8_t)(lit << 4);
        }
        std::memcpy(dst + op, base + anchor, (size_t)lit);
        op += lit;
    }
    #undef EMIT_FAIL

    delete[] head;
    delete[] chain;
    return op;
}

// Emitter for device-generated match candidates (lz4tpu/device/encode.py):
// cand is (k_cands, n) row-major; cand[k*n + p] is the (k+1)-th nearest
// previous position with the same 4 bytes (-1 = none within 64 KiB),
// computed on the device by gram sorting. This walk only verifies/extends/
// emits, keeping the longest candidate per position — no searching.
// One-step lazy deferral like lz4tpu_compress_block.
int64_t lz4tpu_compress_block_cands(
    const uint8_t* base, int64_t hist_len, int64_t src_len,
    const int32_t* cand, int32_t k_cands,
    uint8_t* dst, int64_t dst_cap, int32_t lazy) {
    if (src_len <= 0) return 0;
    const int64_t start = hist_len;
    const int64_t end = hist_len + src_len;
    const int64_t n_all = hist_len + src_len;
    const int64_t MFLIMIT = 12;
    const int64_t MINMATCH = 4;
    const int64_t match_limit = end - 5;
    int64_t ip = start;
    int64_t anchor = start;
    int64_t op = 0;

    auto match_at = [&](int64_t p, int64_t* pos_out) -> int64_t {
        int64_t best = 0;
        const int64_t maxl = match_limit - p;
        for (int32_t k = 0; k < k_cands; ++k) {
            int64_t c = cand[(int64_t)k * n_all + p];
            if (c < 0 || c + 0xFFFF < p) break;  // depths only get older
            if (best > 0 && base[c + best] != base[p + best]) continue;
            if (read32(base + c) != read32(base + p)) continue;  // safety
            int64_t l = extend_match(base, c, p, MINMATCH, maxl);
            if (l > best) { best = l; *pos_out = c; }
            if (best >= maxl) break;
        }
        return best;
    };

    #define CEMIT_FAIL return -1
    while (ip + MFLIMIT <= end) {
        int64_t best_pos = -1;
        int64_t best_len = match_at(ip, &best_pos);
        if (best_len < MINMATCH) {
            ++ip;
            continue;
        }
        if (lazy) {
            while (ip + 1 + MFLIMIT <= end) {
                int64_t pos1 = -1;
                int64_t len1 = match_at(ip + 1, &pos1);
                if (len1 > best_len + 1) {
                    best_len = len1;
                    best_pos = pos1;
                    ++ip;
                } else {
                    break;
                }
            }
        }
        while (ip > anchor && best_pos > 0 &&
               base[best_pos - 1] == base[ip - 1]) {
            --ip; --best_pos; ++best_len;
        }
        const int64_t lit = ip - anchor;
        const int64_t offset = ip - best_pos;
        int64_t mtoken = best_len - MINMATCH;
        if (op + 1 + lit / 255 + 1 + lit + 2 + mtoken / 255 + 1 > dst_cap)
            CEMIT_FAIL;
        uint8_t* tok = dst + op++;
        *tok = 0;
        if (lit >= 15) {
            *tok = 15 << 4;
            int64_t rest = lit - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok = (uint8_t)(lit << 4);
        }
        std::memcpy(dst + op, base + anchor, (size_t)lit);
        op += lit;
        dst[op++] = (uint8_t)(offset & 0xFF);
        dst[op++] = (uint8_t)(offset >> 8);
        if (mtoken >= 15) {
            *tok |= 15;
            int64_t rest = mtoken - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok |= (uint8_t)mtoken;
        }
        ip += best_len;
        anchor = ip;
    }
    {
        const int64_t lit = end - anchor;
        if (op + 1 + lit / 255 + 1 + lit > dst_cap) CEMIT_FAIL;
        if (lit >= 15) {
            dst[op++] = 15 << 4;
            int64_t rest = lit - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            dst[op++] = (uint8_t)(lit << 4);
        }
        std::memcpy(dst + op, base + anchor, (size_t)lit);
        op += lit;
    }
    #undef CEMIT_FAIL
    return op;
}

// ---------------------------------------------------------------------------
// Optimal-parse encoder (exact LZ4 pricing via backward DP)
// ---------------------------------------------------------------------------

static inline int64_t ext_len_price(int64_t v) {
    // extra bytes to encode a 4-bit length field value of v (v = litlen
    // or matchlen-4): 0 if < 15, else 1 + (v-15)/255
    return v < 15 ? 0 : 1 + (v - 15) / 255;
}

// Optimal parse: per position longest match (hash chain), then a
// backward DP over exact sequence prices:
//   cost[i] = min( LIT(n-i),
//                  min_j  1 + ext(j-i) + (j-i) + B[j] )
//   B[j]    = min_m  2 + ext(m-4) + cost[j+m]
// The literal-run coupling is handled exactly for runs < 15 via a
// sliding-window minimum and for runs >= 15 via a suffix minimum
// (runs >= 270 may price 1 byte optimistically; the all-literal LIT
// candidate keeps the emitted stream always valid and near-optimal).
int64_t lz4tpu_compress_block_opt(
    const uint8_t* hist, int64_t hist_len,
    const uint8_t* src, int64_t src_len,
    uint8_t* dst, int64_t dst_cap,
    int32_t max_chain) {
    if (src_len <= 0) return 0;
    const uint8_t* base = (hist_len > 0) ? hist : src;
    const int64_t start = hist_len;
    const int64_t end = hist_len + src_len;
    const int64_t n = src_len;

    static const int HASH_SIZE = 1 << 16;
    int64_t* head = new int64_t[HASH_SIZE]();
    int64_t* chain = new int64_t[1 << 16]();
    int32_t* mlen = new int32_t[n];     // longest match at start+i
    int32_t* moff = new int32_t[n];

    for (int64_t p = (hist_len > 0xFFFF ? hist_len - 0xFFFF : 0);
         hist_len > 0 && p + 4 <= hist_len; ++p) {
        uint32_t h = hash_seq(read32(base + p));
        chain[p & 0xFFFF] = head[h];
        head[h] = p + 1;
    }

    const int64_t match_limit = end - 5;   // matches end at most here
    const int64_t last_start = end - 12;   // matches start at most here
    int64_t capped_off = 0;                // carry for limit-capped matches
    for (int64_t ip = start; ip < end; ++ip) {
        const int64_t i = ip - start;
        mlen[i] = 0;
        moff[i] = 0;
        if (ip <= last_start) {
            // A previous match that ran into match_limit stays maximal
            // when shifted forward: reuse it instead of re-extending
            // (turns runs/periodic data from O(n^2) into O(n)).
            if (capped_off > 0 && match_limit - ip >= 4) {
                mlen[i] = (int32_t)(match_limit - ip);
                moff[i] = (int32_t)capped_off;
                uint32_t h0 = hash_seq(read32(base + ip));
                chain[ip & 0xFFFF] = head[h0];
                head[h0] = ip + 1;
                continue;
            }
            uint32_t h = hash_seq(read32(base + ip));
            int64_t cand = head[h] - 1;
            int tries = max_chain;
            int64_t best = 0, bpos = -1;
            const int64_t maxl = match_limit - ip;
            while (cand >= 0 && cand + 0xFFFF >= ip && tries-- > 0) {
                if (cand < ip
                    && (best == 0 || base[cand + best] == base[ip + best])
                    && read32(base + cand) == read32(base + ip)) {
                    int64_t l = extend_match(base, cand, ip, 4, maxl);
                    if (l >= 4 && l > best) { best = l; bpos = cand; }
                    if (best >= maxl) break;  // cannot improve
                }
                int64_t next = chain[cand & 0xFFFF] - 1;
                if (next >= cand) break;
                cand = next;
            }
            if (best >= 4) {
                mlen[i] = (int32_t)best;
                moff[i] = (int32_t)(ip - bpos);
                capped_off = (best >= maxl) ? (ip - bpos) : 0;
            } else {
                capped_off = 0;
            }
            chain[ip & 0xFFFF] = head[h];
            head[h] = ip + 1;
        } else {
            capped_off = 0;
        }
    }
    delete[] head;
    delete[] chain;

    // Backward DP.
    const int64_t INF = INT64_C(1) << 50;
    int64_t* cost = new int64_t[n + 1];
    int32_t* pick_m = new int32_t[n + 1]();   // chosen match len at j (B[j])
    int64_t* bestB = new int64_t[n + 1];
    int32_t* pick_j = new int32_t[n + 1]();   // chosen match start from i
    // sliding-window min of key(j) = B[j] + j over window [i, i+14]
    int64_t* suffix_min = new int64_t[n + 2];
    // monotonic deque over indices
    int64_t* dq = new int64_t[n + 1];
    int64_t dq_lo = 0, dq_hi = 0;  // [lo, hi)

    cost[n] = 0;
    suffix_min[n] = INF;
    suffix_min[n + 1] = INF;
    for (int64_t i = n - 1; i >= 0; --i) {
        // B[i]: best match-part price if a match starts exactly at i.
        // Candidate lengths: all token-only lengths (4..18), the
        // maximum, a few just below it, and the extension-byte segment
        // boundaries near the maximum — longer candidates within a
        // segment always dominate on price ties, so this set preserves
        // optimality in practice while keeping the DP O(n).
        int64_t B = INF;
        int32_t bm = 0;
        const int64_t L = mlen[i];
        auto try_m = [&](int64_t m) {
            if (m < 4 || m > L) return;
            int64_t c = 2 + ext_len_price(m - 4) + cost[i + m];
            if (c < B) { B = c; bm = (int32_t)m; }
        };
        const int64_t short_top = L < 18 ? L : 18;
        for (int64_t m = 4; m <= short_top; ++m) try_m(m);
        if (L > 18) {
            for (int64_t m = L; m > L - 4 && m > 18; --m) try_m(m);
            // mext segment boundaries: 18, 273, 528, ... (last length
            // before another extension byte is needed)
            const int64_t seg = (L - 19) / 255;
            for (int64_t k = 0; k < 4 && seg - k >= 0; ++k)
                try_m(18 + 255 * (seg - k));
        }
        bestB[i] = B;
        pick_m[i] = bm;

        // push i into the window structures
        const int64_t key = (B >= INF) ? INF : B + i;
        while (dq_hi > dq_lo && (bestB[dq[dq_hi - 1]] >= INF
               ? INF : bestB[dq[dq_hi - 1]] + dq[dq_hi - 1]) >= key)
            --dq_hi;
        dq[dq_hi++] = i;
        while (dq[dq_lo] > i + 14) ++dq_lo;  // never triggers here; kept
        suffix_min[i] = key < suffix_min[i + 1] ? key : suffix_min[i + 1];

        // candidate: all-literal tail
        int64_t best = 1 + ext_len_price(n - i) + (n - i);
        int64_t bj = -1;
        // candidate: short literal run (< 15) then a match — exact
        // evict deque entries beyond the window [i, i+14]
        while (dq_hi > dq_lo && dq[dq_lo] > i + 14) ++dq_lo;
        if (dq_hi > dq_lo) {
            int64_t j = dq[dq_lo];
            int64_t k = bestB[j] >= INF ? INF : bestB[j] + j;
            if (k < INF) {
                int64_t c = 1 + (k - i);
                if (c < best) { best = c; bj = j; }
            }
        }
        // candidate: literal run >= 15 then a match
        if (i + 15 <= n - 1 && suffix_min[i + 15] < INF) {
            int64_t c = 2 + (suffix_min[i + 15] - i);
            if (c < best) {
                best = c;
                bj = -2;  // resolved during emission by re-scan
            }
        }
        cost[i] = best;
        pick_j[i] = (int32_t)(bj >= 0 ? bj : bj);
    }

    // Emission.
    #define OPT_FAIL { delete[] cost; delete[] pick_m; delete[] bestB; \
                       delete[] pick_j; delete[] suffix_min; delete[] dq; \
                       delete[] mlen; delete[] moff; return -1; }
    int64_t op = 0;
    int64_t i = 0;
    while (i < n) {
        int64_t j;
        if (pick_j[i] == -1) {
            j = n;  // tail literals
        } else if (pick_j[i] == -2) {
            // long-run choice: find the j >= i+15 achieving suffix_min
            j = i + 15;
            while (j < n && ((bestB[j] >= INF ? INF : bestB[j] + j)
                             != suffix_min[i + 15]))
                ++j;
        } else {
            j = pick_j[i];
        }
        const int64_t lit = j - i;
        if (j >= n) {
            if (op + 1 + ext_len_price(lit) + lit > dst_cap) OPT_FAIL;
            if (lit >= 15) {
                dst[op++] = 15 << 4;
                int64_t rest = lit - 15;
                while (rest >= 255) { dst[op++] = 255; rest -= 255; }
                dst[op++] = (uint8_t)rest;
            } else {
                dst[op++] = (uint8_t)(lit << 4);
            }
            std::memcpy(dst + op, src + i, (size_t)lit);
            op += lit;
            break;
        }
        const int64_t m = pick_m[j];
        const int64_t off = moff[j];
        if (op + 1 + ext_len_price(lit) + lit + 2 + ext_len_price(m - 4) + 1
            > dst_cap)
            OPT_FAIL;
        uint8_t* tok = dst + op++;
        *tok = 0;
        if (lit >= 15) {
            *tok = 15 << 4;
            int64_t rest = lit - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok = (uint8_t)(lit << 4);
        }
        std::memcpy(dst + op, src + i, (size_t)lit);
        op += lit;
        dst[op++] = (uint8_t)(off & 0xFF);
        dst[op++] = (uint8_t)(off >> 8);
        if (m - 4 >= 15) {
            *tok |= 15;
            int64_t rest = m - 4 - 15;
            while (rest >= 255) { dst[op++] = 255; rest -= 255; }
            dst[op++] = (uint8_t)rest;
        } else {
            *tok |= (uint8_t)(m - 4);
        }
        i = j + m;
    }
    #undef OPT_FAIL

    delete[] cost; delete[] pick_m; delete[] bestB; delete[] pick_j;
    delete[] suffix_min; delete[] dq; delete[] mlen; delete[] moff;
    return op;
}

// ---------------------------------------------------------------------------
// Mechanical token emitter for the device-emission prototype: the
// device has already decided, per position, a QUANTIZED match length
// (0/4/8/16/32, guaranteed-correct by the gram-ladder sorts) and its
// offset.  This function only walks the block linearly and splices the
// token stream — no searching, no byte comparison, no extension (the
// LZ4 grammar emitted: lib/lz4ada.adb:716-788 is the decode side).
// Returns bytes written, or -1 on dst overflow.
int64_t lz4tpu_emit_quantized(
    const uint8_t* buf,       // [hist_len + src_len] joined buffer
    int64_t hist_len, int64_t src_len,
    const uint16_t* elen,     // [hist_len + src_len] 0 = literal
    const uint16_t* eoff,     // [hist_len + src_len]
    uint8_t* dst, int64_t cap) {
    const int64_t end = hist_len + src_len;
    int64_t p = hist_len, o = 0, lit_start = hist_len;
    // standard LZ4 end rules: last 5 bytes are literals, and a match
    // must not run into them
    const int64_t match_end_cap = end - 5;
    while (p < end) {
        int64_t L = elen[p];
        // Prefix-truncate a match that would run into the 5-byte
        // end-literal zone (a prefix of a valid match is valid) —
        // without this, tiny blocks lose their only match entirely.
        if (L > match_end_cap - p) L = match_end_cap - p;
        if (L >= 4 && eoff[p] > 0) {
            // Arithmetic run merge: an adjacent decision at the SAME
            // offset concatenates into one longer match (two matches
            // at equal distance over adjacent spans are one match —
            // still no byte comparison).  The device's log-doubling
            // only merges power-of-two aligned pairs, so e.g. a
            // 992-byte run arrives as 512+256+128+64+32; this splices
            // it into a single token.
            for (;;) {
                const int64_t L_before = L;
                while (p + L < match_end_cap && elen[p + L] >= 4
                       && eoff[p + L] == eoff[p]) {
                    int64_t ext = elen[p + L];
                    if (ext > match_end_cap - (p + L))
                        ext = match_end_cap - (p + L);
                    L += ext;
                    if (ext < elen[p + L - ext]) break;  // truncated
                }
                // Bounded forward extension: the match is guaranteed
                // for L bytes by construction; extending while the
                // actual bytes agree recovers the 1..3-byte residue
                // the 4-byte level quantization drops.  These are the
                // only byte compares in this emitter, and every
                // successful compare advances p, so the total stays
                // O(block).  Loop back: the extension can land on a
                // same-offset follow-up decision, which merges
                // arithmetically again.
                {
                    const int64_t dd = (int64_t)eoff[p];
                    while (p + L < match_end_cap
                           && buf[p + L] == buf[p + L - dd]) ++L;
                }
                if (L == L_before) break;
            }
            const int64_t lit = p - lit_start;
            const int64_t ml = L - 4;
            // token + ext lit lens + literals + offset + ext match len
            int64_t need = 1 + (lit >= 15 ? (lit - 15) / 255 + 1 : 0)
                           + lit + 2 + (ml >= 15 ? (ml - 15) / 255 + 1 : 0);
            if (o + need > cap) return -1;
            int64_t lt = lit < 15 ? lit : 15;
            int64_t mt = ml < 15 ? ml : 15;
            dst[o++] = (uint8_t)((lt << 4) | mt);
            if (lit >= 15) {
                int64_t r = lit - 15;
                while (r >= 255) { dst[o++] = 255; r -= 255; }
                dst[o++] = (uint8_t)r;
            }
            memcpy(dst + o, buf + lit_start, (size_t)lit);
            o += lit;
            dst[o++] = (uint8_t)(eoff[p] & 255);
            dst[o++] = (uint8_t)(eoff[p] >> 8);
            if (ml >= 15) {
                int64_t r = ml - 15;
                while (r >= 255) { dst[o++] = 255; r -= 255; }
                dst[o++] = (uint8_t)r;
            }
            p += L;
            lit_start = p;
        } else {
            ++p;
        }
    }
    // final literals-only sequence (match nibble 0 is legal at block
    // end: lz4ada.adb:752-764)
    const int64_t lit = p - lit_start;
    int64_t need = 1 + (lit >= 15 ? (lit - 15) / 255 + 1 : 0) + lit;
    if (o + need > cap) return -1;
    dst[o++] = (uint8_t)((lit < 15 ? lit : 15) << 4);
    if (lit >= 15) {
        int64_t r = lit - 15;
        while (r >= 255) { dst[o++] = 255; r -= 255; }
        dst[o++] = (uint8_t)r;
    }
    memcpy(dst + o, buf + lit_start, (size_t)lit);
    o += lit;
    return o;
}


}  // extern "C"
