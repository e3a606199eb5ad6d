"""The plain reference: exact integer NumPy/PyTorch, independent of the
program. It imports nothing of `hexl_tpu_torch` or of `hexl_tpu`, and works
out its own roots, twiddles and constants from the primes."""

from .modarith import mulmod, mulmod_f64
from .ntt import Tables, forward, inverse
from .he import dyadic, key_switch
