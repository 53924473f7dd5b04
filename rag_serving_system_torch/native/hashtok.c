/* Native host-side tokenizer hot path.
 *
 * Implements exactly the Python HashTokenizer algorithm
 * (models/tokenizer.py): split text on \w+|[^\w\s] (ASCII subset), hash each
 * token with BLAKE2b (digest_size=4, RFC 7693), map to
 * reserved + (h % (vocab_size - reserved)).
 *
 * Scope: pure-ASCII strings only — encode() returns -1 when a byte >= 0x80
 * is seen and the Python caller falls back to its own implementation, so
 * C/Python parity is exact by construction. The serving corpora and the
 * benchmark loads are ASCII; this path removes the per-token hashlib +
 * regex overhead from the request hot loop (GIL released via ctypes).
 *
 * Build: cc -O2 -shared -fPIC -o libhashtok.so hashtok.c  (see build.sh)
 */

#include <stdint.h>
#include <string.h>

/* ----------------------------- BLAKE2b (RFC 7693) ---------------------- */

static const uint64_t blake2b_iv[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t blake2b_sigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

static inline uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

static inline uint64_t load64(const uint8_t *p) {
    uint64_t v;
    memcpy(&v, p, 8); /* little-endian hosts (x86-64, arm64) */
    return v;
}

#define G(r, i, a, b, c, d)                          \
    do {                                             \
        a = a + b + m[blake2b_sigma[r][2 * i]];      \
        d = rotr64(d ^ a, 32);                       \
        c = c + d;                                   \
        b = rotr64(b ^ c, 24);                       \
        a = a + b + m[blake2b_sigma[r][2 * i + 1]];  \
        d = rotr64(d ^ a, 16);                       \
        c = c + d;                                   \
        b = rotr64(b ^ c, 63);                       \
    } while (0)

static void blake2b_compress(uint64_t h[8], const uint8_t block[128],
                             uint64_t t, int last) {
    uint64_t m[16], v[16];
    int i, r;
    for (i = 0; i < 16; i++) m[i] = load64(block + 8 * i);
    for (i = 0; i < 8; i++) v[i] = h[i];
    for (i = 0; i < 8; i++) v[i + 8] = blake2b_iv[i];
    v[12] ^= t;         /* t0 (inputs < 2^64 bytes) */
    if (last) v[14] = ~v[14];
    for (r = 0; r < 12; r++) {
        G(r, 0, v[0], v[4], v[8], v[12]);
        G(r, 1, v[1], v[5], v[9], v[13]);
        G(r, 2, v[2], v[6], v[10], v[14]);
        G(r, 3, v[3], v[7], v[11], v[15]);
        G(r, 4, v[0], v[5], v[10], v[15]);
        G(r, 5, v[1], v[6], v[11], v[12]);
        G(r, 6, v[2], v[7], v[8], v[13]);
        G(r, 7, v[3], v[4], v[9], v[14]);
    }
    for (i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

/* blake2b with digest_size=4, no key; returns little-endian uint32 digest */
static uint32_t blake2b_u32(const uint8_t *data, uint64_t len) {
    uint64_t h[8];
    uint8_t block[128];
    uint64_t t = 0;
    int i;
    for (i = 0; i < 8; i++) h[i] = blake2b_iv[i];
    h[0] ^= 0x01010000ULL ^ 4ULL; /* depth=1, fanout=1, digest_len=4 */

    while (len > 128) {
        memcpy(block, data, 128);
        t += 128;
        blake2b_compress(h, block, t, 0);
        data += 128;
        len -= 128;
    }
    memset(block, 0, 128);
    memcpy(block, data, (size_t)len);
    t += len;
    blake2b_compress(h, block, t, 1);
    return (uint32_t)(h[0] & 0xffffffffULL);
}

/* ------------------------------ tokenizer ------------------------------ */

static inline int is_word(uint8_t c) {
    return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
           (c >= 'A' && c <= 'Z') || c == '_';
}

static inline int is_space(uint8_t c) {
    /* Python's re \s over str: [ \t\n\r\v\f] plus the ASCII separators
     * FS/GS/RS/US (0x1c-0x1f), which Python treats as whitespace. */
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
           c == '\f' || (c >= 0x1c && c <= 0x1f);
}

/* Tokenize `s[0:len]` (ASCII) like Python's \w+|[^\w\s], hash each token,
 * write ids (bos + tokens + eos) into out[0:cap].
 * Returns number of ids written, or -1 if a non-ASCII byte was seen. */
int hashtok_encode(const char *s, int len, int32_t *out, int cap,
                   int vocab_size, int reserved, int bos_id, int eos_id) {
    int n = 0, i = 0;
    uint32_t mod = (uint32_t)(vocab_size - reserved);
    if (n < cap) out[n++] = bos_id;
    while (i < len) {
        uint8_t c = (uint8_t)s[i];
        if (c >= 0x80) return -1; /* non-ASCII: caller falls back to Python */
        if (is_space(c)) {
            i++;
            continue;
        }
        int start = i;
        if (is_word(c)) {
            while (i < len && (uint8_t)s[i] < 0x80 && is_word((uint8_t)s[i]))
                i++;
            if (i < len && (uint8_t)s[i] >= 0x80) return -1;
        } else {
            i++; /* single punctuation char */
        }
        if (n < cap) {
            uint32_t hv = blake2b_u32((const uint8_t *)s + start,
                                      (uint64_t)(i - start));
            out[n++] = (int32_t)(reserved + (hv % mod));
        } else {
            return n; /* truncated at cap, matching Python's [:max_len] */
        }
    }
    if (n < cap) out[n++] = eos_id;
    return n;
}

/* Batch API: rows of a (batch, cap) int32 buffer; lens[] gives per-string
 * byte lengths, offsets[] the start of each string in the packed buffer.
 * Returns 0 on success; row count written into counts[]; any row that needs
 * the Python fallback gets counts[row] = -1. */
int hashtok_encode_batch(const char *buf, const int64_t *offsets,
                         const int32_t *lens, int batch, int32_t *out,
                         int cap, int vocab_size, int reserved, int bos_id,
                         int eos_id, int32_t *counts) {
    int r;
    for (r = 0; r < batch; r++) {
        counts[r] = hashtok_encode(buf + offsets[r], lens[r], out + (int64_t)r * cap,
                                   cap, vocab_size, reserved, bos_id, eos_id);
    }
    return 0;
}
