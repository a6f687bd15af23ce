from .chain import chain_jnp, chain_triton, make_compact_chain
from .tail import (
    TAIL_BODIES,
    fused_tail_jnp,
    fused_tail_triton,
    make_fused_tail,
    tail_kernel_ok,
)
