// Keccak-256 (Ethereum 0x01 padding) on the host.
//
// The MPT state-root recomputation hashes thousands of RLP-encoded trie
// nodes per block (reference: lib/src/primitives/mpt.rs:117-121, the hot
// keccak path).  The CUDA kernel (raiko_tpu_torch/ops/keccak.py) covers
// large batches; this C++ library covers the host-side sequential path
// (node reference computation inside trie traversal, sender addresses, the
// instance hash) where per-call latency matters more than throughput.
// Built with g++ and loaded through ctypes by raiko_tpu_torch/utils/native.py.
//
// Constants are derived at static-init time from the FIPS-202 LFSR / pi-walk
// definitions rather than transcribed.

#include <cstdint>
#include <cstring>

namespace {

uint64_t RC[24];
int RHO[5][5];

struct ConstInit {
  ConstInit() {
    // round constants from LFSR x^8+x^6+x^5+x^4+1
    auto rc_bit = [](int t) -> int {
      t %= 255;
      if (t == 0) return 1;
      int r = 1;
      for (int i = 0; i < t; i++) {
        r <<= 1;
        if (r & 0x100) r ^= 0x171;
      }
      return r & 1;
    };
    for (int ir = 0; ir < 24; ir++) {
      uint64_t rc = 0;
      for (int j = 0; j < 7; j++)
        if (rc_bit(j + 7 * ir)) rc |= 1ULL << ((1 << j) - 1);
      RC[ir] = rc;
    }
    // rho offsets via the (x,y) -> (y, 2x+3y) walk
    RHO[0][0] = 0;
    int x = 1, y = 0;
    for (int t = 0; t < 24; t++) {
      RHO[x][y] = ((t + 1) * (t + 2) / 2) % 64;
      int nx = y, ny = (2 * x + 3 * y) % 5;
      x = nx;
      y = ny;
    }
  }
} const_init;

inline uint64_t rotl(uint64_t v, int n) {
  n &= 63;
  return n ? (v << n) | (v >> (64 - n)) : v;
}

void keccak_f1600(uint64_t a[25]) {
  for (int round = 0; round < 24; round++) {
    uint64_t c[5], d[5], b[25];
    for (int i = 0; i < 5; i++)
      c[i] = a[i] ^ a[i + 5] ^ a[i + 10] ^ a[i + 15] ^ a[i + 20];
    for (int i = 0; i < 5; i++) d[i] = c[(i + 4) % 5] ^ rotl(c[(i + 1) % 5], 1);
    for (int i = 0; i < 5; i++)
      for (int j = 0; j < 5; j++) a[i + 5 * j] ^= d[i];
    for (int i = 0; i < 5; i++)
      for (int j = 0; j < 5; j++)
        b[j + 5 * ((2 * i + 3 * j) % 5)] = rotl(a[i + 5 * j], RHO[i][j]);
    for (int i = 0; i < 5; i++)
      for (int j = 0; j < 5; j++)
        a[i + 5 * j] = b[i + 5 * j] ^ (~b[(i + 1) % 5 + 5 * j] & b[(i + 2) % 5 + 5 * j]);
    a[0] ^= RC[round];
  }
}

void keccak256_one(const uint8_t* data, uint64_t len, uint8_t* out) {
  constexpr uint64_t RATE = 136;
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  uint64_t off = 0;
  while (len - off >= RATE) {
    for (int i = 0; i < 17; i++) {
      uint64_t lane;
      std::memcpy(&lane, data + off + 8 * i, 8);
      st[i] ^= lane;  // little-endian host assumed (x86/arm64)
    }
    keccak_f1600(st);
    off += RATE;
  }
  uint8_t block[RATE];
  uint64_t rem = len - off;
  std::memset(block, 0, RATE);
  std::memcpy(block, data + off, rem);
  block[rem] ^= 0x01;
  block[RATE - 1] ^= 0x80;
  for (int i = 0; i < 17; i++) {
    uint64_t lane;
    std::memcpy(&lane, block + 8 * i, 8);
    st[i] ^= lane;
  }
  keccak_f1600(st);
  std::memcpy(out, st, 32);
}

}  // namespace

extern "C" {

void raiko_keccak256(const uint8_t* data, uint64_t len, uint8_t* out32) {
  keccak256_one(data, len, out32);
}

// n variable-length messages packed back-to-back; offsets has n+1 entries.
void raiko_keccak256_batch(const uint8_t* data, const uint64_t* offsets,
                           uint64_t n, uint8_t* out) {
  for (uint64_t i = 0; i < n; i++)
    keccak256_one(data + offsets[i], offsets[i + 1] - offsets[i], out + 32 * i);
}

}  // extern "C"
