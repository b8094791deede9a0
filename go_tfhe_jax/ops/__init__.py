"""Compute kernels: exact negacyclic polynomial arithmetic, decomposition,
rotation, external product, blind rotation, key switching, sample extraction.

These are the batched equivalents of the reference's hand-optimized
``poly/`` FFT kernels (SURVEY.md §2 rows 3-7, 10, 13).
"""

from .blindrotate import blind_rotate, mod_switch_2n
from .decompose import gadget_decompose
from .extprod import cmux, decompose_i8, external_product
from .keyswitch import identity_key_switch, ks_digits
from .polymul import (conv_kernel_from_poly, ext_band_from_trgsw,
                      extprod_kernel_from_trgsw, negacyclic_extprod_i8,
                      negacyclic_extprod_i32, negacyclic_extprod_toeplitz,
                      negacyclic_mul_fixed, prepare_band_limbs,
                      split_balanced_limbs_i8, toeplitz_from_band)
from .rotate import monomial_mul
from .sample_extract import sample_extract, sample_extract_to_lv0
