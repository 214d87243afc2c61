"""Hand-written Hopper kernels of the port, each beside its plain version.

| kernel | wrapper | plain version | replaces (JAX package) |
|---|---|---|---|
| K1 | ``flash_attention`` | ``attention_reference`` | ``ops/flash_attention.py flash_attention`` |
| K5 | ``decode_attention`` | ``decode_attention_reference`` | ``ops/decode_attention.py decode_attention`` |
| K2 | ``decode_attention_layer`` | ``decode_attention_reference`` | ``ops/decode_attention.py decode_attention_layer`` |
| K3 | ``decode_block_attention_layer`` | ``decode_block_attention_reference`` | ``ops/decode_attention.py decode_block_attention_layer`` |
| K4 | ``masked_argmax_advance`` | ``masked_argmax_advance_reference`` | ``ops/grammar_mask.py masked_argmax_advance`` |
| K6 | ``paged_attention`` | ``paged_attention_reference`` | ``ops/paged_attention.py paged_attention`` |
| K7 | ``paged_block_attention`` | ``paged_block_attention_reference`` | ``ops/paged_attention.py paged_block_attention`` |
| K8 | ``paged_attention_quant`` | ``paged_attention_quant_reference`` | ``ops/paged_attention.py paged_attention_quant`` |
| K9 | ``paged_block_attention_quant`` | ``paged_block_attention_quant_reference`` | ``ops/paged_attention.py paged_block_attention_quant`` |
| K10 | ``decode_attention_quant`` | ``decode_attention_quant_reference`` | ``ops/decode_attention.py decode_attention_quant`` |
| K11 | ``masked_argmax`` (``masked_argmax_block``) | ``masked_argmax_reference`` | ``ops/grammar_mask.py masked_argmax`` |
| K12 | ``decode_block_attention`` | ``decode_block_attention_reference`` | ``ops/decode_attention.py decode_block_attention`` |
| K13 | ``grouped_matmul`` | ``grouped_matmul_reference`` | ``ops/grouped_matmul.py grouped_matmul`` |

``ops.sharded`` runs K1, K2, K3, K5, K4 and K11 over a dp x tp mesh, one
launch per shard (the ``sharded_*`` wrappers of the JAX package).

Each wrapper counts its kernel launches in a plain integer attribute,
``wrapper.launches``; ``launch_counts`` reads them all and
``reset_launch_counts`` sets them to 0.
"""

from .decode_attention import (
    decode_attention,
    decode_attention_layer,
    decode_attention_quant,
    decode_attention_quant_reference,
    decode_attention_reference,
    decode_block_attention,
    decode_block_attention_layer,
    decode_block_attention_reference,
)
from .flash_attention import attention_reference, flash_attention
from .grouped_matmul import dequantize_leaf, grouped_matmul, grouped_matmul_reference
from .grammar_mask import (
    masked_argmax,
    masked_argmax_advance,
    masked_argmax_advance_reference,
    masked_argmax_block,
    masked_argmax_reference,
)
from .paged_attention import (
    paged_attention,
    paged_attention_quant,
    paged_attention_quant_reference,
    paged_attention_reference,
    paged_block_attention,
    paged_block_attention_quant,
    paged_block_attention_quant_reference,
    paged_block_attention_reference,
)
from .sharded import (
    sharded_decode_attention,
    sharded_decode_attention_layer,
    sharded_decode_block_attention_layer,
    sharded_flash_attention,
    sharded_masked_argmax,
    sharded_masked_argmax_advance,
    sharded_masked_argmax_block,
)

KERNELS = {
    "flash_attention": flash_attention,
    "decode_attention_layer": decode_attention_layer,
    "decode_attention": decode_attention,
    "decode_block_attention_layer": decode_block_attention_layer,
    "masked_argmax_advance": masked_argmax_advance,
    "paged_attention": paged_attention,
    "paged_block_attention": paged_block_attention,
    "paged_attention_quant": paged_attention_quant,
    "paged_block_attention_quant": paged_block_attention_quant,
    "decode_attention_quant": decode_attention_quant,
    "masked_argmax": masked_argmax,
    "decode_block_attention": decode_block_attention,
    "grouped_matmul": grouped_matmul,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "attention_reference",
    "decode_attention",
    "decode_attention_layer",
    "decode_attention_quant",
    "decode_attention_quant_reference",
    "decode_attention_reference",
    "decode_block_attention",
    "decode_block_attention_layer",
    "decode_block_attention_reference",
    "dequantize_leaf",
    "flash_attention",
    "grouped_matmul",
    "grouped_matmul_reference",
    "launch_counts",
    "masked_argmax",
    "masked_argmax_advance",
    "masked_argmax_advance_reference",
    "masked_argmax_block",
    "masked_argmax_reference",
    "paged_attention",
    "paged_attention_quant",
    "paged_attention_quant_reference",
    "paged_attention_reference",
    "paged_block_attention",
    "paged_block_attention_quant",
    "paged_block_attention_quant_reference",
    "paged_block_attention_reference",
    "reset_launch_counts",
    "sharded_decode_attention",
    "sharded_decode_attention_layer",
    "sharded_decode_block_attention_layer",
    "sharded_flash_attention",
    "sharded_masked_argmax",
    "sharded_masked_argmax_advance",
    "sharded_masked_argmax_block",
]
