// LZ4 block-format codec (compress + decompress), implemented from the
// public LZ4 block specification: the port's copy of
// simpleslam_tpu/native/lz4.cpp (the keyframe thumbnails' codec), byte for
// byte the same output.
//
// Exposed via a C ABI for ctypes binding (simpleslam_tpu_torch/native.py).
// Built at first use by simpleslam_tpu_torch/utils/cuda_build.py with the
// host's C++ compiler.
//
// Format notes (LZ4 block spec):
//   sequence = token(1B) [lit-len ext] literals [match: 2B little-endian
//   offset, matchlen ext]; minimum match 4; last 5 bytes are literals-only;
//   matches must not start within the last 12 bytes.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr int MINMATCH = 4;
constexpr int MFLIMIT = 12;     // last bytes that cannot start a match
constexpr int LASTLITERALS = 5; // final literal run minimum

constexpr int HASH_LOG = 16;
constexpr uint32_t HASH_SIZE = 1u << HASH_LOG;

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_LOG);
}

}  // namespace

extern "C" {

// Worst-case compressed size for n input bytes (LZ4_compressBound formula).
size_t slam_lz4_bound(size_t n) { return n + n / 255 + 16; }

// Compress src[0..n) into dst (capacity >= slam_lz4_bound(n)).
// Returns compressed size, or 0 on failure.
size_t slam_lz4_compress(const uint8_t* src, size_t n, uint8_t* dst,
                         size_t dst_cap) {
    if (n == 0) return 0;
    if (dst_cap < slam_lz4_bound(n)) return 0;

    uint32_t table[HASH_SIZE];
    std::memset(table, 0xFF, sizeof(table));  // 0xFFFFFFFF = empty

    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    const uint8_t* const mflimit = (n >= (size_t)MFLIMIT) ? iend - MFLIMIT : src;
    const uint8_t* anchor = src;
    uint8_t* op = dst;

    if (n >= (size_t)MFLIMIT) {
        while (ip < mflimit) {
            // find a 4-byte match via hash table
            uint32_t h = hash4(read32(ip));
            uint32_t cand = table[h];
            table[h] = (uint32_t)(ip - src);
            const uint8_t* match = src + cand;
            if (cand == 0xFFFFFFFFu || (size_t)(ip - match) > 65535 ||
                read32(match) != read32(ip)) {
                ++ip;
                continue;
            }

            // extend the match forward
            const uint8_t* mp = match + MINMATCH;
            const uint8_t* cp = ip + MINMATCH;
            const uint8_t* const matchlimit = iend - LASTLITERALS;
            while (cp < matchlimit && *cp == *mp) { ++cp; ++mp; }
            size_t match_len = (size_t)(cp - ip) - MINMATCH;
            size_t lit_len = (size_t)(ip - anchor);
            uint16_t offset = (uint16_t)(ip - match);

            // token
            uint8_t* token = op++;
            // literal length
            if (lit_len >= 15) {
                *token = (uint8_t)(15u << 4);
                size_t rem = lit_len - 15;
                while (rem >= 255) { *op++ = 255; rem -= 255; }
                *op++ = (uint8_t)rem;
            } else {
                *token = (uint8_t)(lit_len << 4);
            }
            std::memcpy(op, anchor, lit_len);
            op += lit_len;
            // offset
            *op++ = (uint8_t)(offset & 0xFF);
            *op++ = (uint8_t)(offset >> 8);
            // match length
            if (match_len >= 15) {
                *token |= 15;
                size_t rem = match_len - 15;
                while (rem >= 255) { *op++ = 255; rem -= 255; }
                *op++ = (uint8_t)rem;
            } else {
                *token |= (uint8_t)match_len;
            }

            ip = cp;
            anchor = ip;
            if (ip < mflimit) {
                // seed the table inside the match for better ratios
                table[hash4(read32(ip - 2))] = (uint32_t)(ip - 2 - src);
            }
        }
    }

    // trailing literals
    size_t lit_len = (size_t)(iend - anchor);
    uint8_t* token = op++;
    if (lit_len >= 15) {
        *token = (uint8_t)(15u << 4);
        size_t rem = lit_len - 15;
        while (rem >= 255) { *op++ = 255; rem -= 255; }
        *op++ = (uint8_t)rem;
    } else {
        *token = (uint8_t)(lit_len << 4);
    }
    std::memcpy(op, anchor, lit_len);
    op += lit_len;

    return (size_t)(op - dst);
}

// Decompress src[0..n) into dst of exactly dst_len bytes.
// Returns dst_len on success, 0 on malformed input.
size_t slam_lz4_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                           size_t dst_len) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_len;

    while (ip < iend) {
        uint8_t token = *ip++;
        // literals
        size_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return 0;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > iend || op + lit > oend) return 0;
        std::memcpy(op, ip, lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // last sequence has no match part

        // match
        if (ip + 2 > iend) return 0;
        uint16_t offset = (uint16_t)(ip[0] | (ip[1] << 8));
        ip += 2;
        if (offset == 0 || (size_t)(op - dst) < offset) return 0;
        size_t mlen = (token & 15) + MINMATCH;
        if ((token & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return 0;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        if (op + mlen > oend) return 0;
        const uint8_t* mp = op - offset;
        // byte-by-byte: overlapping copies are the point of LZ4
        for (size_t i = 0; i < mlen; ++i) op[i] = mp[i];
        op += mlen;
    }
    return (size_t)(op - dst) == dst_len ? dst_len : 0;
}

}  // extern "C"
