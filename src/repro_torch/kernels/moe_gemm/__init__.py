from .ops import (expert_mlp, grouped_gemm, grouped_gemm_bwd_ref,  # noqa: F401
                  grouped_gemm_ref, moe_grouped_gemm)
