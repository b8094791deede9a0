"""go_tfhe_jax — a batched TFHE framework in JAX.

A from-scratch re-design of the capabilities of ``thedonutfactory/go-tfhe``
(pure-Go CPU TFHE) for accelerators: batched-first, functional, jitted, with
exact mod-2^32 int8 matmuls instead of float64 FFTs.  See SURVEY.md at the
repo root for the full component map.
"""

from . import bitutils, cipher, engine, gates, keys, lut, models, ops, parallel
from . import params as params_module
from . import proxyreenc, utils
from .cipher import (lwe_decrypt_bool, lwe_decrypt_message, lwe_encrypt_bool,
                     lwe_encrypt_message, lwe_encrypt_torus)
from .engine import bootstrap, bootstrap_many, bootstrap_without_key_switch
from .keys import (CloudKey, SecretKey, gen_cloud_key, gen_cloud_key_no_ksk,
                   gen_secret_key, load_cloud_key, load_secret_key,
                   save_cloud_key, save_secret_key)
from .params import (DEFAULT, P80, P110, P128, PROFILES, TEST_BLOCK,
                     TEST_EXT2, TEST_EXT3, TEST_FAST, TEST_NIBBLE, TEST_PBS,
                     UINT1, UINT2, UINT3, UINT4, UINT5, UINT6, UINT7, UINT8,
                     TFHEParams, get_params, security_info)

__version__ = "0.1.0"
