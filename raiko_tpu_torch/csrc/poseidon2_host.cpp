// Host Poseidon2 over BabyBear: the permutation of ops/poseidon2.py's
// host_permute in C, for the code that runs it one state at a time on the
// host (the Fiat-Shamir channel, the verifier's Merkle paths, the
// transcript AIR's trace).  Built by g++ at first use and loaded with
// ctypes by ops/poseidon2_host.py; not a CUDA kernel.
//
// Width 16, S-box x^7, 4 external rounds, 13 internal rounds, 4 external
// rounds, the M4 circulant external layer and the `sum + mu_i * x_i`
// internal layer, all on standard-form elements.  The round constants
// are not compiled in: raiko_p2_init takes them from Python
// (ops/poseidon2.host_constants), so there is one derivation of them.
// Every element is reduced below p, so each result equals the Python
// version's bit for bit, whatever the order of the reductions.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t P = 2013265921u;  // 15 * 2^27 + 1
constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int OUT = 8;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 13;

uint64_t g_ext_rc[ROUNDS_F][WIDTH];
uint64_t g_int_rc[ROUNDS_P];
uint64_t g_mu[WIDTH];

const uint64_t M4[4][4] = {{5, 7, 1, 3}, {4, 6, 1, 1}, {1, 3, 5, 7}, {1, 1, 4, 6}};

inline uint64_t sbox(uint64_t x) {
  uint64_t x2 = x * x % P;
  uint64_t x3 = x2 * x % P;
  return x3 * x3 % P * x % P;
}

inline void ext_linear(uint64_t* s) {
  uint64_t grp[4][4];
  for (int g = 0; g < 4; ++g)
    for (int i = 0; i < 4; ++i) {
      const uint64_t* x = s + 4 * g;
      grp[g][i] = (M4[i][0] * x[0] + M4[i][1] * x[1] + M4[i][2] * x[2] + M4[i][3] * x[3]) % P;
    }
  for (int i = 0; i < 4; ++i) {
    uint64_t sum = (grp[0][i] + grp[1][i] + grp[2][i] + grp[3][i]) % P;
    for (int g = 0; g < 4; ++g) s[4 * g + i] = (grp[g][i] + sum) % P;
  }
}

inline void int_linear(uint64_t* s) {
  uint64_t tot = 0;
  for (int c = 0; c < WIDTH; ++c) tot += s[c];
  tot %= P;
  for (int c = 0; c < WIDTH; ++c) s[c] = (tot + g_mu[c] * s[c]) % P;
}

// s: 16 elements below p
void permute(uint64_t* s) {
  ext_linear(s);
  for (int r = 0; r < ROUNDS_F / 2; ++r) {
    for (int c = 0; c < WIDTH; ++c) s[c] = sbox((s[c] + g_ext_rc[r][c]) % P);
    ext_linear(s);
  }
  for (int r = 0; r < ROUNDS_P; ++r) {
    s[0] = sbox((s[0] + g_int_rc[r]) % P);
    int_linear(s);
  }
  for (int r = ROUNDS_F / 2; r < ROUNDS_F; ++r) {
    for (int c = 0; c < WIDTH; ++c) s[c] = sbox((s[c] + g_ext_rc[r][c]) % P);
    ext_linear(s);
  }
}

inline void load(uint64_t* s, const uint32_t* src) {
  for (int c = 0; c < WIDTH; ++c) s[c] = src[c] % P;
}

inline void store(uint32_t* dst, const uint64_t* s, int n) {
  for (int c = 0; c < n; ++c) dst[c] = static_cast<uint32_t>(s[c]);
}

// the row sponge of ops/poseidon2.host_hash_row: capacity word 15 holds
// the width, rate-8 chunks added in, the last one zero-padded
void hash_row(const uint32_t* row, uint64_t w, uint64_t* out) {
  uint64_t s[WIDTH] = {0};
  s[WIDTH - 1] = w % P;
  uint64_t nchunks = w == 0 ? 1 : (w + RATE - 1) / RATE;
  for (uint64_t c = 0; c < nchunks; ++c) {
    for (int i = 0; i < RATE; ++i) {
      uint64_t k = c * RATE + i;
      if (k < w) s[i] = (s[i] + row[k] % P) % P;
    }
    permute(s);
  }
  for (int i = 0; i < OUT; ++i) out[i] = s[i];
}

// compress(left, right): the first 8 words of the permuted concatenation
void compress(const uint64_t* left, const uint64_t* right, uint64_t* out) {
  uint64_t s[WIDTH];
  for (int i = 0; i < OUT; ++i) {
    s[i] = left[i];
    s[OUT + i] = right[i];
  }
  permute(s);
  for (int i = 0; i < OUT; ++i) out[i] = s[i];
}

}  // namespace

extern "C" {

// consts: external rc (8 x 16), internal rc (13), mu (16), standard form
void raiko_p2_init(const uint32_t* consts) {
  for (int r = 0; r < ROUNDS_F; ++r)
    for (int c = 0; c < WIDTH; ++c) g_ext_rc[r][c] = consts[r * WIDTH + c] % P;
  for (int r = 0; r < ROUNDS_P; ++r) g_int_rc[r] = consts[ROUNDS_F * WIDTH + r] % P;
  for (int c = 0; c < WIDTH; ++c) g_mu[c] = consts[ROUNDS_F * WIDTH + ROUNDS_P + c] % P;
}

// n states of 16 words, permuted in place
void raiko_p2_permute(uint32_t* states, uint64_t n) {
  for (uint64_t b = 0; b < n; ++b) {
    uint64_t s[WIDTH];
    load(s, states + WIDTH * b);
    permute(s);
    store(states + WIDTH * b, s, WIDTH);
  }
}

// The duplex absorb of stark/channel.py: for each chunk of up to 8 of the
// n elements, add it into the state's first words and permute.
void raiko_p2_absorb(uint32_t* state, const uint32_t* elems, uint64_t n) {
  uint64_t s[WIDTH];
  load(s, state);
  for (uint64_t off = 0; off < n; off += RATE) {
    for (uint64_t i = 0; i < RATE && off + i < n; ++i) s[i] = (s[i] + elems[off + i] % P) % P;
    permute(s);
  }
  store(state, s, WIDTH);
}

// The squeeze of stark/channel.py: read the state's first 8 words, then
// permute, until n elements are out (out holds n rounded up to 8).
void raiko_p2_squeeze(uint32_t* state, uint32_t* out, uint64_t n) {
  uint64_t s[WIDTH];
  load(s, state);
  for (uint64_t off = 0; off < n; off += RATE) {
    store(out + off, s, RATE);
    permute(s);
  }
  store(state, s, WIDTH);
}

// n rows of w words (row-major) -> n digests of 8 words
void raiko_p2_hash_rows(const uint32_t* rows, uint64_t n, uint64_t w, uint32_t* out) {
  for (uint64_t r = 0; r < n; ++r) {
    uint64_t d[OUT];
    hash_row(rows + r * w, w, d);
    store(out + OUT * r, d, OUT);
  }
}

// n pairs (left 8, right 8 words each) -> n digests
void raiko_p2_compress(const uint32_t* pairs, uint64_t n, uint32_t* out) {
  for (uint64_t r = 0; r < n; ++r) {
    uint64_t l[OUT], rt[OUT], d[OUT];
    for (int i = 0; i < OUT; ++i) {
      l[i] = pairs[2 * OUT * r + i] % P;
      rt[i] = pairs[2 * OUT * r + OUT + i] % P;
    }
    compress(l, rt, d);
    store(out + OUT * r, d, OUT);
  }
}

// Walk a Merkle path from a leaf digest: at each level the sibling goes
// left when the index is odd.  Returns 1 when the walk ends at root.
int raiko_p2_path_ok(const uint32_t* leaf, uint64_t index, const uint32_t* path, uint64_t depth,
                     const uint32_t* root) {
  uint64_t cur[OUT], sib[OUT];
  for (int i = 0; i < OUT; ++i) cur[i] = leaf[i] % P;
  for (uint64_t k = 0; k < depth; ++k) {
    for (int i = 0; i < OUT; ++i) sib[i] = path[OUT * k + i] % P;
    if (index & 1)
      compress(sib, cur, cur);
    else
      compress(cur, sib, cur);
    index >>= 1;
  }
  for (int i = 0; i < OUT; ++i)
    if (cur[i] != root[i] % P) return 0;
  return 1;
}

// A row's digest, then its path: the verifier's query check in one call.
int raiko_p2_row_path_ok(const uint32_t* row, uint64_t w, uint64_t index, const uint32_t* path,
                         uint64_t depth, const uint32_t* root) {
  uint64_t d[OUT];
  uint32_t leaf[OUT];
  hash_row(row, w, d);
  store(leaf, d, OUT);
  return raiko_p2_path_ok(leaf, index, path, depth, root);
}

}  // extern "C"
