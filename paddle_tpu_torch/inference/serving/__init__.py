"""paddle_tpu_torch.inference.serving — continuous-batching decode
server over a paged KV cache, with ragged paged decode attention as a
hand-written CUDA kernel on the card.

    from paddle_tpu_torch.inference.serving import (LLMServer,
                                                    params_from_numpy)
    server = LLMServer(params=params_from_numpy(tree, device="cuda"),
                       gpt_config=cfg, max_batch=8, num_blocks=512)
    print(server.submit(prompt_ids, max_tokens=64).result().tokens)
"""

from .kv_cache import (BlockAllocator, OutOfBlocks, PagedKVCache,
                       PageTable, SCRATCH_BLOCK, gather_pages,
                       paged_append, write_prompt_pages,
                       write_prompt_pages_group)
from .ragged_attention import (DENOM_TINY, MASK_VALUE,
                               causal_prefill_attention,
                               paged_decode_attention,
                               ragged_decode_attention)
from .paged_attention_kernel import (paged_ragged_attention,
                                     paged_ragged_attention_reference)
from .sampling import sample_tokens
from .decode_model import (GPTDecodeWeights, ServingModelConfig,
                           decode_forward, params_from_numpy,
                           prefill_forward, prefill_group_forward,
                           reference_decode)
from .scheduler import QueueFull, Request, RequestStats, Scheduler
from .engine import DecodeEngine, ENGINE_ROLES, GenerationResult
from .api import LLMServer

__all__ = [
    "BlockAllocator", "OutOfBlocks", "PagedKVCache", "PageTable",
    "SCRATCH_BLOCK", "gather_pages", "paged_append",
    "write_prompt_pages", "write_prompt_pages_group",
    "DENOM_TINY", "MASK_VALUE", "causal_prefill_attention",
    "paged_decode_attention", "ragged_decode_attention",
    "paged_ragged_attention", "paged_ragged_attention_reference",
    "sample_tokens",
    "GPTDecodeWeights", "ServingModelConfig", "decode_forward",
    "params_from_numpy", "prefill_forward", "prefill_group_forward",
    "reference_decode",
    "QueueFull", "Request", "RequestStats", "Scheduler",
    "DecodeEngine", "ENGINE_ROLES", "GenerationResult", "LLMServer",
]
