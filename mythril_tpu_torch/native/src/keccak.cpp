// Batched keccak-256 on the host path.
//
// Counterpart of the reference's pysha3 C extension (SURVEY.md §2.9): concrete
// hashing for code hashes, selectors, and the probe's model validation.  The
// device path has its own Pallas kernel (mythril_tpu/ops/keccak_pallas.py);
// this one serves host Python via ctypes (mythril_tpu/native/keccak.py).

#include <cstdint>
#include <cstring>

namespace {

const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

const int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                     25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

inline uint64_t rotl(uint64_t x, int n) {
  return n == 0 ? x : (x << n) | (x >> (64 - n));
}

void keccak_f1600(uint64_t st[25]) {
  for (int round = 0; round < 24; round++) {
    uint64_t bc[5], t;
    // theta
    for (int x = 0; x < 5; x++)
      bc[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
    for (int x = 0; x < 5; x++) {
      t = bc[(x + 4) % 5] ^ rotl(bc[(x + 1) % 5], 1);
      for (int y = 0; y < 25; y += 5) st[x + y] ^= t;
    }
    // rho + pi
    uint64_t b[25];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) {
        int src = x + 5 * y;
        int dst = y + 5 * ((2 * x + 3 * y) % 5);
        b[dst] = rotl(st[src], ROT[src]);
      }
    // chi
    for (int y = 0; y < 25; y += 5)
      for (int x = 0; x < 5; x++)
        st[y + x] = b[y + x] ^ ((~b[y + (x + 1) % 5]) & b[y + (x + 2) % 5]);
    // iota
    st[0] ^= RC[round];
  }
}

void keccak256_one(const uint8_t* data, int64_t len, uint8_t* out) {
  const int64_t RATE = 136;
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  int64_t off = 0;
  while (len - off >= RATE) {
    for (int i = 0; i < RATE / 8; i++) {
      uint64_t lane;
      std::memcpy(&lane, data + off + 8 * i, 8);
      st[i] ^= lane;  // little-endian host assumed (x86/ARM)
    }
    keccak_f1600(st);
    off += RATE;
  }
  uint8_t block[136];
  std::memset(block, 0, sizeof(block));
  std::memcpy(block, data + off, (size_t)(len - off));
  block[len - off] = 0x01;  // keccak (pre-NIST) padding
  block[RATE - 1] |= 0x80;
  for (int i = 0; i < RATE / 8; i++) {
    uint64_t lane;
    std::memcpy(&lane, block + 8 * i, 8);
    st[i] ^= lane;
  }
  keccak_f1600(st);
  std::memcpy(out, st, 32);
}

}  // namespace

extern "C" {

// n messages of uniform byte length `len` (concatenated) -> n x 32-byte digests
void keccak256_batch(const uint8_t* data, int64_t n, int64_t len, uint8_t* out) {
  for (int64_t i = 0; i < n; i++)
    keccak256_one(data + i * len, len, out + i * 32);
}

void keccak256_single(const uint8_t* data, int64_t len, uint8_t* out) {
  keccak256_one(data, len, out);
}

}  // extern "C"
