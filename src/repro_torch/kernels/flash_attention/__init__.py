from .ops import (flash_attention, flash_attention_bwd,  # noqa: F401
                  flash_attention_bwd_ref, flash_attention_lse_ref,
                  flash_attention_ref)
