/* A Zstandard decoder (RFC 8878, the decoding side only), with a plain C
 * interface for ctypes.
 *
 *   long long zstd_decompress(const unsigned char *src, size_t src_size,
 *                             unsigned char *dst, size_t dst_capacity);
 *
 * decodes every frame in src (skippable frames are skipped) into dst and
 * returns the number of bytes written, or a negative error code:
 *   -1 malformed input, -2 dst too small, -3 unsupported (dictionaries).
 *   long long zstd_content_size(const unsigned char *src, size_t src_size);
 * returns the first frame's declared content size, or -1 when the header
 * does not declare one.
 *
 * Content checksums are skipped, not verified. No allocation: every table
 * lives on the stack or in a context struct on the stack.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define ERR_CORRUPT (-1)
#define ERR_DST (-2)
#define ERR_UNSUPPORTED (-3)

#define MAX_BLOCK (128 * 1024)
#define HUF_MAX_BITS 11
#define HUF_MAX_SYMBS 256
#define FSE_MAX_LOG 9
#define FSE_MAX_SYMBS 256

typedef struct {
    uint8_t symbol;
    uint8_t nbits;
    uint16_t base;
} fse_entry;

typedef struct {
    int log;                    /* accuracy log; the table has 1 << log rows */
    fse_entry t[1 << FSE_MAX_LOG];
} fse_table;

typedef struct {
    int max_bits;
    uint8_t symbol[1 << HUF_MAX_BITS];
    uint8_t nbits[1 << HUF_MAX_BITS];
} huf_table;

typedef struct {
    huf_table huf;
    int huf_ok;
    fse_table ll, of, ml;
    int ll_ok, of_ok, ml_ok;
    uint32_t rep[3];
    uint8_t lit[MAX_BLOCK + 64];
} frame_ctx;

/* ---------------------------------------------------------------- bits */

static int highbit(uint32_t v) { /* index of the highest set bit, v > 0 */
    int n = 0;
    while (v >>= 1) n++;
    return n;
}

/* Forward bit reader (FSE table descriptions): bits are taken from the
 * least significant end of each little-endian byte. */
typedef struct {
    const uint8_t *p;
    size_t len;
    size_t pos; /* bit position */
} fwd_bits;

static uint32_t fwd_peek(const fwd_bits *b, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
        size_t bit = b->pos + i;
        uint32_t x = (bit >> 3) < b->len ? (b->p[bit >> 3] >> (bit & 7)) & 1 : 0;
        v |= x << i;
    }
    return v;
}

/* Backward bit reader (Huffman and FSE streams): the stream is read from
 * its last byte towards its first; the highest set bit of the last byte
 * marks the start. Reading past the first byte yields zeros and makes
 * `pos` negative. */
typedef struct {
    const uint8_t *p;
    size_t len;
    int64_t pos; /* bits left */
} back_bits;

static int back_init(back_bits *b, const uint8_t *p, size_t len) {
    if (len == 0 || p[len - 1] == 0) return ERR_CORRUPT;
    b->p = p;
    b->len = len;
    b->pos = (int64_t)len * 8 - (8 - highbit(p[len - 1]));
    return 0;
}

static inline uint64_t back_peek(const back_bits *b, int n) {
    if (n == 0) return 0;
    int64_t lo = b->pos - n;
    if (lo >= 0) {
        size_t byte = (size_t)(lo >> 3);
        uint64_t w = 0;
        size_t avail = b->len - byte;
        if (avail >= 8) {
            memcpy(&w, b->p + byte, 8);
        } else {
            for (size_t i = 0; i < avail; i++) w |= (uint64_t)b->p[byte + i] << (8 * i);
        }
        return (w >> (lo & 7)) & ((1ull << n) - 1);
    }
    /* the low (-lo) bits lie before the stream: zeros */
    int have = (int)b->pos;
    if (have <= 0) return 0;
    uint64_t w = 0;
    size_t nb = (size_t)((have + 7) >> 3);
    for (size_t i = 0; i < nb && i < b->len; i++) w |= (uint64_t)b->p[i] << (8 * i);
    w &= (have >= 64) ? ~0ull : ((1ull << have) - 1);
    return w << (-lo);
}

static inline uint64_t back_read(back_bits *b, int n) {
    uint64_t v = back_peek(b, n);
    b->pos -= n;
    return v;
}

/* ----------------------------------------------------------------- FSE */

/* Reads an FSE table description; returns bytes consumed or < 0. */
static long fse_read_header(const uint8_t *src, size_t len, int16_t *norm,
                            int *n_symbols, int *log, int max_log, int max_symbols) {
    fwd_bits b = {src, len, 0};
    if (len == 0) return ERR_CORRUPT;
    int al = (int)fwd_peek(&b, 4) + 5;
    b.pos += 4;
    if (al > max_log) return ERR_CORRUPT;
    int remaining = 1 << al;
    int symb = 0;
    while (remaining > 0 && symb < max_symbols) {
        int bits = highbit((uint32_t)remaining + 1) + 1;
        uint32_t val = fwd_peek(&b, bits);
        uint32_t lower_mask = (1u << (bits - 1)) - 1;
        uint32_t threshold = (1u << bits) - 1 - ((uint32_t)remaining + 1);
        if ((val & lower_mask) < threshold) {
            val &= lower_mask;
            b.pos += bits - 1;
        } else {
            if (val > lower_mask) val -= threshold;
            b.pos += bits;
        }
        int proba = (int)val - 1;
        remaining -= proba < 0 ? -proba : proba;
        norm[symb++] = (int16_t)proba;
        if (proba == 0) {
            for (;;) {
                uint32_t rep = fwd_peek(&b, 2);
                b.pos += 2;
                for (uint32_t i = 0; i < rep && symb < max_symbols; i++) norm[symb++] = 0;
                if (rep != 3) break;
            }
        }
        if ((b.pos >> 3) > len) return ERR_CORRUPT;
    }
    if (remaining != 0) return ERR_CORRUPT;
    *n_symbols = symb;
    *log = al;
    return (long)((b.pos + 7) >> 3);
}

static int fse_build(fse_table *t, const int16_t *norm, int n_symbols, int log) {
    int size = 1 << log;
    int high = size;
    uint16_t next[FSE_MAX_SYMBS];
    t->log = log;
    for (int s = 0; s < n_symbols; s++) {
        if (norm[s] == -1) {
            t->t[--high].symbol = (uint8_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint16_t)(norm[s] > 0 ? norm[s] : 0);
        }
    }
    int step = (size >> 1) + (size >> 3) + 3;
    int mask = size - 1;
    int pos = 0;
    for (int s = 0; s < n_symbols; s++) {
        for (int i = 0; i < norm[s]; i++) {
            t->t[pos].symbol = (uint8_t)s;
            do {
                pos = (pos + step) & mask;
            } while (pos >= high);
        }
    }
    if (pos != 0) return ERR_CORRUPT;
    for (int i = 0; i < size; i++) {
        int s = t->t[i].symbol;
        uint16_t state = next[s]++;
        int nb = log - highbit(state);
        t->t[i].nbits = (uint8_t)nb;
        t->t[i].base = (uint16_t)((state << nb) - size);
    }
    return 0;
}

static void fse_rle(fse_table *t, uint8_t symbol) {
    t->log = 0;
    t->t[0].symbol = symbol;
    t->t[0].nbits = 0;
    t->t[0].base = 0;
}

/* ------------------------------------------------------------- Huffman */

static int huf_build(huf_table *h, const uint8_t *weights, int n) {
    /* n weights given; the last symbol's weight is implied */
    uint32_t total = 0;
    uint8_t w[HUF_MAX_SYMBS];
    for (int i = 0; i < n; i++) {
        if (weights[i] > HUF_MAX_BITS) return ERR_CORRUPT;
        w[i] = weights[i];
        if (w[i]) total += 1u << (w[i] - 1);
    }
    if (total == 0 || n >= HUF_MAX_SYMBS) return ERR_CORRUPT;
    int max_bits = highbit(total) + 1;
    uint32_t rest = (1u << max_bits) - total;
    if (rest & (rest - 1)) return ERR_CORRUPT; /* not a power of two */
    w[n] = (uint8_t)(highbit(rest) + 1);
    int n_symbols = n + 1;
    if (max_bits > HUF_MAX_BITS) return ERR_CORRUPT;
    uint8_t bits[HUF_MAX_SYMBS];
    int rank_count[HUF_MAX_BITS + 2] = {0};
    for (int i = 0; i < n_symbols; i++) {
        bits[i] = w[i] ? (uint8_t)(max_bits + 1 - w[i]) : 0;
        rank_count[bits[i]]++;
    }
    uint32_t rank_idx[HUF_MAX_BITS + 2];
    rank_idx[max_bits] = 0;
    for (int i = max_bits; i >= 1; i--) {
        rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (max_bits - i));
        for (uint32_t j = rank_idx[i]; j < rank_idx[i - 1]; j++) h->nbits[j] = (uint8_t)i;
    }
    if (rank_idx[0] != (1u << max_bits)) return ERR_CORRUPT;
    for (int i = 0; i < n_symbols; i++) {
        if (!bits[i]) continue;
        uint32_t code = rank_idx[bits[i]];
        uint32_t len = 1u << (max_bits - bits[i]);
        memset(&h->symbol[code], i, len);
        rank_idx[bits[i]] += len;
    }
    h->max_bits = max_bits;
    return 0;
}

/* Reads a Huffman tree description; returns bytes consumed or < 0. */
static long huf_read_tree(huf_table *h, const uint8_t *src, size_t len) {
    if (len < 1) return ERR_CORRUPT;
    uint8_t weights[HUF_MAX_SYMBS + 1];
    int n = 0;
    int header = src[0];
    long used;
    if (header >= 128) {
        n = header - 127;
        size_t nbytes = ((size_t)n + 1) / 2;
        if (1 + nbytes > len) return ERR_CORRUPT;
        for (int i = 0; i < n; i++) {
            uint8_t byte = src[1 + i / 2];
            weights[i] = (i & 1) ? (byte & 15) : (byte >> 4);
        }
        used = 1 + (long)nbytes;
    } else {
        size_t csize = (size_t)header;
        if (1 + csize > len) return ERR_CORRUPT;
        const uint8_t *p = src + 1;
        int16_t norm[FSE_MAX_SYMBS];
        int n_sym, al;
        long hl = fse_read_header(p, csize, norm, &n_sym, &al, 6, 256);
        if (hl < 0) return hl;
        fse_table t;
        if (fse_build(&t, norm, n_sym, al) < 0) return ERR_CORRUPT;
        back_bits b;
        if (back_init(&b, p + hl, csize - (size_t)hl) < 0) return ERR_CORRUPT;
        uint32_t s1 = (uint32_t)back_read(&b, al);
        uint32_t s2 = (uint32_t)back_read(&b, al);
        for (;;) {
            if (n >= HUF_MAX_SYMBS) return ERR_CORRUPT;
            weights[n++] = t.t[s1].symbol;
            s1 = t.t[s1].base + (uint32_t)back_read(&b, t.t[s1].nbits);
            if (b.pos < 0) {
                if (n >= HUF_MAX_SYMBS) return ERR_CORRUPT;
                weights[n++] = t.t[s2].symbol;
                break;
            }
            if (n >= HUF_MAX_SYMBS) return ERR_CORRUPT;
            weights[n++] = t.t[s2].symbol;
            s2 = t.t[s2].base + (uint32_t)back_read(&b, t.t[s2].nbits);
            if (b.pos < 0) {
                if (n >= HUF_MAX_SYMBS) return ERR_CORRUPT;
                weights[n++] = t.t[s1].symbol;
                break;
            }
        }
        used = 1 + (long)csize;
    }
    if (huf_build(h, weights, n) < 0) return ERR_CORRUPT;
    return used;
}

static int huf_stream(const huf_table *h, const uint8_t *src, size_t len,
                      uint8_t *out, size_t n_out) {
    back_bits b;
    if (back_init(&b, src, len) < 0) return ERR_CORRUPT;
    int mb = h->max_bits;
    for (size_t i = 0; i < n_out; i++) {
        uint32_t idx = (uint32_t)back_peek(&b, mb);
        out[i] = h->symbol[idx];
        b.pos -= h->nbits[idx];
    }
    return b.pos == 0 ? 0 : ERR_CORRUPT;
}

/* ------------------------------------------------------------ literals */

/* Decodes the literals section; sets *n_lit and returns bytes consumed. */
static long read_literals(frame_ctx *c, const uint8_t *src, size_t len, size_t *n_lit) {
    if (len < 1) return ERR_CORRUPT;
    int type = src[0] & 3;
    int sf = (src[0] >> 2) & 3;
    size_t regen, csize = 0, hsize;
    if (type < 2) {
        if ((sf & 1) == 0) {
            regen = src[0] >> 3;
            hsize = 1;
        } else if (sf == 1) {
            if (len < 2) return ERR_CORRUPT;
            regen = (src[0] >> 4) + ((size_t)src[1] << 4);
            hsize = 2;
        } else {
            if (len < 3) return ERR_CORRUPT;
            regen = (src[0] >> 4) + ((size_t)src[1] << 4) + ((size_t)src[2] << 12);
            hsize = 3;
        }
        if (regen > MAX_BLOCK) return ERR_CORRUPT;
        if (type == 0) {
            if (hsize + regen > len) return ERR_CORRUPT;
            memcpy(c->lit, src + hsize, regen);
            *n_lit = regen;
            return (long)(hsize + regen);
        }
        if (hsize + 1 > len) return ERR_CORRUPT;
        memset(c->lit, src[hsize], regen);
        *n_lit = regen;
        return (long)(hsize + 1);
    }
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
        if (len < 3) return ERR_CORRUPT;
        regen = (src[0] >> 4) + ((size_t)(src[1] & 0x3f) << 4);
        csize = (src[1] >> 6) + ((size_t)src[2] << 2);
        hsize = 3;
    } else if (sf == 2) {
        if (len < 4) return ERR_CORRUPT;
        regen = (src[0] >> 4) + ((size_t)src[1] << 4) + ((size_t)(src[2] & 3) << 12);
        csize = (src[2] >> 2) + ((size_t)src[3] << 6);
        hsize = 4;
    } else {
        if (len < 5) return ERR_CORRUPT;
        regen = (src[0] >> 4) + ((size_t)src[1] << 4) + ((size_t)(src[2] & 0x3f) << 12);
        csize = (src[2] >> 6) + ((size_t)src[3] << 2) + ((size_t)src[4] << 10);
        hsize = 5;
    }
    if (regen > MAX_BLOCK || hsize + csize > len) return ERR_CORRUPT;
    const uint8_t *p = src + hsize;
    size_t plen = csize;
    if (type == 2) {
        long tl = huf_read_tree(&c->huf, p, plen);
        if (tl < 0) return tl;
        c->huf_ok = 1;
        p += tl;
        plen -= (size_t)tl;
    } else if (!c->huf_ok) {
        return ERR_CORRUPT;
    }
    if (streams == 1) {
        if (huf_stream(&c->huf, p, plen, c->lit, regen) < 0) return ERR_CORRUPT;
    } else {
        if (plen < 6) return ERR_CORRUPT;
        size_t s1 = p[0] | ((size_t)p[1] << 8);
        size_t s2 = p[2] | ((size_t)p[3] << 8);
        size_t s3 = p[4] | ((size_t)p[5] << 8);
        if (6 + s1 + s2 + s3 > plen) return ERR_CORRUPT;
        size_t s4 = plen - 6 - s1 - s2 - s3;
        size_t seg = (regen + 3) / 4;
        if (3 * seg > regen) return ERR_CORRUPT;
        const uint8_t *q = p + 6;
        size_t sizes[4] = {s1, s2, s3, s4};
        for (int i = 0; i < 4; i++) {
            size_t n = i < 3 ? seg : regen - 3 * seg;
            if (huf_stream(&c->huf, q, sizes[i], c->lit + i * seg, n) < 0) return ERR_CORRUPT;
            q += sizes[i];
        }
    }
    *n_lit = regen;
    return (long)(hsize + csize);
}

/* ----------------------------------------------------------- sequences */

static const uint32_t LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
    8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
    12, 13, 14, 15, 16};
static const int16_t LL_DEFAULT[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
    -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
    -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

/* Reads one symbol-compression table (mode 0-3); returns bytes consumed. */
static long read_seq_table(fse_table *t, int *ok, int mode, const uint8_t *src, size_t len,
                           const int16_t *def, int def_n, int def_log, int max_log,
                           int max_symbol) {
    if (mode == 0) {
        if (fse_build(t, def, def_n, def_log) < 0) return ERR_CORRUPT;
        *ok = 1;
        return 0;
    }
    if (mode == 1) {
        if (len < 1 || src[0] > max_symbol) return ERR_CORRUPT;
        fse_rle(t, src[0]);
        *ok = 1;
        return 1;
    }
    if (mode == 2) {
        int16_t norm[FSE_MAX_SYMBS];
        int n, al;
        long hl = fse_read_header(src, len, norm, &n, &al, max_log, max_symbol + 1);
        if (hl < 0) return hl;
        if (fse_build(t, norm, n, al) < 0) return ERR_CORRUPT;
        *ok = 1;
        return hl;
    }
    return *ok ? 0 : ERR_CORRUPT;
}

static long decode_block(frame_ctx *c, const uint8_t *src, size_t len, uint8_t *dst,
                         size_t dst_cap, size_t pos, size_t frame_start) {
    size_t n_lit;
    long ll = read_literals(c, src, len, &n_lit);
    if (ll < 0) return ll;
    const uint8_t *p = src + ll;
    size_t plen = len - (size_t)ll;
    if (plen < 1) return ERR_CORRUPT;
    size_t n_seq;
    if (p[0] < 128) {
        n_seq = p[0];
        p += 1;
        plen -= 1;
    } else if (p[0] < 255) {
        if (plen < 2) return ERR_CORRUPT;
        n_seq = ((size_t)(p[0] - 128) << 8) + p[1];
        p += 2;
        plen -= 2;
    } else {
        if (plen < 3) return ERR_CORRUPT;
        n_seq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
        p += 3;
        plen -= 3;
    }
    size_t lit_pos = 0;
    if (n_seq > 0) {
        if (plen < 1) return ERR_CORRUPT;
        int modes = p[0];
        if (modes & 3) return ERR_CORRUPT;
        p += 1;
        plen -= 1;
        long r = read_seq_table(&c->ll, &c->ll_ok, (modes >> 6) & 3, p, plen, LL_DEFAULT, 36,
                                6, 9, 35);
        if (r < 0) return r;
        p += r;
        plen -= (size_t)r;
        r = read_seq_table(&c->of, &c->of_ok, (modes >> 4) & 3, p, plen, OF_DEFAULT, 29, 5, 8,
                           31);
        if (r < 0) return r;
        p += r;
        plen -= (size_t)r;
        r = read_seq_table(&c->ml, &c->ml_ok, (modes >> 2) & 3, p, plen, ML_DEFAULT, 53, 6, 9,
                           52);
        if (r < 0) return r;
        p += r;
        plen -= (size_t)r;
        back_bits b;
        if (back_init(&b, p, plen) < 0) return ERR_CORRUPT;
        uint32_t sll = (uint32_t)back_read(&b, c->ll.log);
        uint32_t sof = (uint32_t)back_read(&b, c->of.log);
        uint32_t sml = (uint32_t)back_read(&b, c->ml.log);
        for (size_t i = 0; i < n_seq; i++) {
            int of_code = c->of.t[sof].symbol;
            int ml_code = c->ml.t[sml].symbol;
            int ll_code = c->ll.t[sll].symbol;
            if (of_code > 31 || ml_code > 52 || ll_code > 35) return ERR_CORRUPT;
            uint32_t of_value = (1u << of_code) + (uint32_t)back_read(&b, of_code);
            uint32_t ml = ML_BASE[ml_code] + (uint32_t)back_read(&b, ML_BITS[ml_code]);
            uint32_t lln = LL_BASE[ll_code] + (uint32_t)back_read(&b, LL_BITS[ll_code]);
            uint32_t offset;
            if (of_value > 3) {
                offset = of_value - 3;
                c->rep[2] = c->rep[1];
                c->rep[1] = c->rep[0];
                c->rep[0] = offset;
            } else {
                uint32_t idx = of_value - 1 + (lln == 0);
                if (idx == 0) {
                    offset = c->rep[0];
                } else {
                    offset = idx < 3 ? c->rep[idx] : c->rep[0] - 1;
                    if (idx > 1) c->rep[2] = c->rep[1];
                    c->rep[1] = c->rep[0];
                    c->rep[0] = offset;
                }
            }
            if (lit_pos + lln > n_lit) return ERR_CORRUPT;
            if (pos + lln + ml > dst_cap) return ERR_DST;
            memcpy(dst + pos, c->lit + lit_pos, lln);
            pos += lln;
            lit_pos += lln;
            if (offset == 0 || offset > pos - frame_start) return ERR_CORRUPT;
            uint8_t *out = dst + pos;
            const uint8_t *from = out - offset;
            if (offset >= ml) {
                memcpy(out, from, ml);
            } else {
                for (uint32_t k = 0; k < ml; k++) out[k] = from[k];
            }
            pos += ml;
            if (i + 1 < n_seq) {
                sll = c->ll.t[sll].base + (uint32_t)back_read(&b, c->ll.t[sll].nbits);
                sml = c->ml.t[sml].base + (uint32_t)back_read(&b, c->ml.t[sml].nbits);
                sof = c->of.t[sof].base + (uint32_t)back_read(&b, c->of.t[sof].nbits);
            }
        }
        if (b.pos != 0) return ERR_CORRUPT;
    }
    size_t rest = n_lit - lit_pos;
    if (pos + rest > dst_cap) return ERR_DST;
    memcpy(dst + pos, c->lit + lit_pos, rest);
    return (long)(pos + rest);
}

/* --------------------------------------------------------------- frame */

typedef struct {
    size_t header_size;
    int64_t content_size; /* -1 when not declared */
    int checksum;
} frame_header;

static int read_frame_header(const uint8_t *src, size_t len, frame_header *h) {
    if (len < 5) return ERR_CORRUPT;
    int fhd = src[4];
    int fcs_flag = fhd >> 6;
    int single = (fhd >> 5) & 1;
    int did_flag = fhd & 3;
    if (fhd & 8) return ERR_CORRUPT; /* reserved bit */
    size_t p = 5;
    if (!single) p += 1;             /* window descriptor */
    static const int did_size[4] = {0, 1, 2, 4};
    for (int i = 0; i < did_size[did_flag]; i++) {
        if (p + (size_t)i >= len) return ERR_CORRUPT;
        if (src[p + i]) return ERR_UNSUPPORTED;
    }
    p += (size_t)did_size[did_flag];
    int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
    if (p + (size_t)fcs_size > len) return ERR_CORRUPT;
    int64_t fcs = -1;
    if (fcs_size) {
        uint64_t v = 0;
        for (int i = 0; i < fcs_size; i++) v |= (uint64_t)src[p + i] << (8 * i);
        if (fcs_size == 2) v += 256;
        fcs = (int64_t)v;
    }
    h->header_size = p + (size_t)fcs_size;
    h->content_size = fcs;
    h->checksum = (fhd >> 2) & 1;
    return 0;
}

long long zstd_content_size(const unsigned char *src, size_t src_size) {
    if (src_size < 4 || src[0] != 0x28 || src[1] != 0xB5 || src[2] != 0x2F || src[3] != 0xFD)
        return ERR_CORRUPT;
    frame_header h;
    int e = read_frame_header(src, src_size, &h);
    if (e < 0) return e;
    return h.content_size;
}

long long zstd_decompress(const unsigned char *src, size_t src_size, unsigned char *dst,
                          size_t dst_capacity) {
    frame_ctx c;
    size_t in = 0, out = 0;
    while (in < src_size) {
        if (src_size - in < 4) return ERR_CORRUPT;
        uint32_t magic = src[in] | ((uint32_t)src[in + 1] << 8) | ((uint32_t)src[in + 2] << 16) |
                         ((uint32_t)src[in + 3] << 24);
        if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) { /* skippable frame */
            if (src_size - in < 8) return ERR_CORRUPT;
            size_t n = src[in + 4] | ((size_t)src[in + 5] << 8) | ((size_t)src[in + 6] << 16) |
                       ((size_t)src[in + 7] << 24);
            if (n > src_size - in - 8) return ERR_CORRUPT;
            in += 8 + n;
            continue;
        }
        if (magic != 0xFD2FB528u) return ERR_CORRUPT;
        frame_header h;
        int e = read_frame_header(src + in, src_size - in, &h);
        if (e < 0) return e;
        in += h.header_size;
        c.huf_ok = c.ll_ok = c.of_ok = c.ml_ok = 0;
        c.rep[0] = 1;
        c.rep[1] = 4;
        c.rep[2] = 8;
        size_t frame_start = out;
        for (;;) {
            if (src_size - in < 3) return ERR_CORRUPT;
            uint32_t bh = src[in] | ((uint32_t)src[in + 1] << 8) | ((uint32_t)src[in + 2] << 16);
            in += 3;
            int last = bh & 1;
            int type = (bh >> 1) & 3;
            size_t size = bh >> 3;
            if (type == 0) {
                if (size > src_size - in) return ERR_CORRUPT;
                if (out + size > dst_capacity) return ERR_DST;
                memcpy(dst + out, src + in, size);
                out += size;
                in += size;
            } else if (type == 1) {
                if (in >= src_size) return ERR_CORRUPT;
                if (out + size > dst_capacity) return ERR_DST;
                memset(dst + out, src[in], size);
                out += size;
                in += 1;
            } else if (type == 2) {
                if (size > src_size - in || size > MAX_BLOCK) return ERR_CORRUPT;
                long r = decode_block(&c, src + in, size, dst, dst_capacity, out, frame_start);
                if (r < 0) return r;
                out = (size_t)r;
                in += size;
            } else {
                return ERR_CORRUPT;
            }
            if (last) break;
        }
        if (h.checksum) {
            if (src_size - in < 4) return ERR_CORRUPT;
            in += 4;
        }
        if (h.content_size >= 0 && (int64_t)(out - frame_start) != h.content_size)
            return ERR_CORRUPT;
    }
    return (long long)out;
}
