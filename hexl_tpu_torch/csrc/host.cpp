// hexl_tpu_torch native host library: number theory and twiddle tables.
//
// The port's own copy of the JAX package's host library, with the same five
// C entries (ht_is_prime, ht_generate_primes, ht_inverse_mod,
// ht_minimal_primitive_root, ht_root_tables). Plan construction (the
// per-(N, q) twiddle tables, reference behaviour:
// hexl/ntt/ntt-internal.cpp:54-169) is host work of O(N log q); in Python
// integers it costs seconds at N = 2^20. g++ builds this file into
// build/hexl_tpu_torch/<hash>/libhost.so at first use (_build.build_host),
// and native.py binds it with ctypes; the pure-Python forms in nt.py and
// ntt/plan.py stay as the plain versions, taken only when
// HEXL_TPU_DISABLE_NATIVE is set.
//
// All arithmetic uses unsigned __int128: exact for q < 2^64.

#include <cstdint>

extern "C" {

typedef unsigned __int128 u128;

static uint64_t mul_mod(uint64_t a, uint64_t b, uint64_t q) {
  return (uint64_t)(((u128)a * b) % q);
}

static uint64_t pow_mod(uint64_t base, uint64_t exp, uint64_t q) {
  uint64_t result = 1;
  base %= q;
  while (exp > 0) {
    if (exp & 1) result = mul_mod(result, base, q);
    base = mul_mod(base, base, q);
    exp >>= 1;
  }
  return result;
}

int ht_is_prime(uint64_t n) {
  static const uint64_t witnesses[12] = {2,  3,  5,  7,  11, 13,
                                         17, 19, 23, 29, 31, 37};
  if (n < 2) return 0;
  for (uint64_t a : witnesses) {
    if (n == a) return 1;
    if (n % a == 0) return 0;
  }
  uint64_t d = n - 1;
  int r = 0;
  while ((d & 1) == 0) {
    d >>= 1;
    ++r;
  }
  for (uint64_t a : witnesses) {
    uint64_t x = pow_mod(a, d, n);
    if (x == 1 || x == n - 1) continue;
    bool composite = true;
    for (int i = 1; i < r; ++i) {
      x = mul_mod(x, x, n);
      if (x == n - 1) {
        composite = false;
        break;
      }
    }
    if (composite) return 0;
  }
  return 1;
}

// Scan for primes q in (2^bit_size, 2^(bit_size+1)) with q = 1 mod 2*ntt_size.
// Returns the number found (may be < num if the range is exhausted).
int64_t ht_generate_primes(int64_t num, int64_t bit_size,
                           int prefer_small, uint64_t ntt_size,
                           uint64_t* out) {
  const uint64_t lower = (1ULL << bit_size) + 1;
  const uint64_t upper = (1ULL << (bit_size + 1)) - 1;
  const uint64_t step = 2 * ntt_size;
  uint64_t candidate =
      prefer_small ? lower : upper - (upper % step) + 1;
  int64_t found = 0;
  while (prefer_small ? (candidate <= upper) : (candidate >= lower)) {
    if (ht_is_prime(candidate)) {
      out[found++] = candidate;
      if (found == num) return found;
    }
    candidate = prefer_small ? candidate + step : candidate - step;
  }
  return found;
}

uint64_t ht_inverse_mod(uint64_t x, uint64_t q) {
  // Extended Euclid on (x mod q, q); assumes gcd == 1.
  int64_t t = 0, new_t = 1;
  uint64_t r = q, new_r = x % q;
  while (new_r != 0) {
    uint64_t quot = r / new_r;
    int64_t tmp_t = t - (int64_t)quot * new_t;
    t = new_t;
    new_t = tmp_t;
    uint64_t tmp_r = r - quot * new_r;
    r = new_r;
    new_r = tmp_r;
  }
  if (t < 0) t += (int64_t)q;
  return (uint64_t)t;
}

static int is_primitive_root(uint64_t root, uint64_t degree, uint64_t q) {
  if (root == 0) return 0;
  return pow_mod(root, degree / 2, q) == q - 1;
}

// Deterministic minimal primitive degree-th root of unity mod q:
// find any generator by scanning small candidates raised to the quotient
// power, then take the minimum over its odd powers (the set of all
// primitive roots).
uint64_t ht_minimal_primitive_root(uint64_t degree, uint64_t q) {
  const uint64_t quotient = (q - 1) / degree;
  uint64_t root = 0;
  for (uint64_t candidate = 2; candidate < q; ++candidate) {
    uint64_t r = pow_mod(candidate, quotient, q);
    if (is_primitive_root(r, degree, q)) {
      root = r;
      break;
    }
  }
  if (root == 0) return 0;
  uint64_t root_sq = mul_mod(root, root, q);
  uint64_t current = root, best = root;
  for (uint64_t i = 0; i < degree; ++i) {
    if (current < best) best = current;
    current = mul_mod(current, root_sq, q);
  }
  return best;
}

static uint64_t reverse_bits(uint64_t x, int bits) {
  uint64_t out = 0;
  for (int i = 0; i < bits; ++i) {
    out = (out << 1) | (x & 1);
    x >>= 1;
  }
  return out;
}

static uint64_t barrett64(uint64_t operand, uint64_t q) {
  // floor((operand << 64) / q)
  return (uint64_t)((((u128)operand) << 64) / q);
}

// Builds all four tables the NTT plan needs:
//   rop[rev(i)]   = w^i                      (bit-reversed forward powers)
//   irop          = stage-major reorder of (w^{-i} at bit-reversed index)
//   prop / pirop  = floor(v << 64 / q) Shoup preconditioning of each.
// Layout parity with the reference engine's tables.
int ht_root_tables(uint64_t n, uint64_t q, uint64_t w, uint64_t* rop,
                   uint64_t* irop, uint64_t* prop, uint64_t* pirop) {
  int bits = 0;
  while ((1ULL << bits) < n) ++bits;
  const uint64_t w_inv = ht_inverse_mod(w, q);

  // irop_raw built into irop buffer first, then reordered in place.
  uint64_t* irop_raw = pirop;  // reuse as scratch before filling precon
  uint64_t power = 1, inv_power = 1;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t idx = reverse_bits(i, bits);
    rop[idx] = power;
    irop_raw[idx] = inv_power;
    power = mul_mod(power, w, q);
    inv_power = mul_mod(inv_power, w_inv, q);
  }
  // Stage-major reorder: irop[0]=raw[0]; then for m=n/2..1 append raw[m..2m)
  irop[0] = irop_raw[0];
  uint64_t idx = 1;
  for (uint64_t m = n >> 1; m > 0; m >>= 1)
    for (uint64_t i = 0; i < m; ++i) irop[idx++] = irop_raw[m + i];
  // Preconditioning (overwrites the scratch).
  for (uint64_t i = 0; i < n; ++i) prop[i] = barrett64(rop[i], q);
  for (uint64_t i = 0; i < n; ++i) pirop[i] = barrett64(irop[i], q);
  return 0;
}

}  // extern "C"
