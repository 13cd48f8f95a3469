"""Model zoo of the port: the dense and MoE families (GQA or MLA attention),
Mamba-1, the Mamba-2 hybrid with its shared attention block, and the VLM
and audio frontends (``repro.models`` in PyTorch).

Public API:
  transformer.model_layout(cfg)      → ParamDef tree (shapes + logical axes)
  common.init_params(generator, layout) → parameter tree of tensors
  transformer.forward(params, cfg, batch, ...) → (logits, cache, aux)
  transformer.cache_layout(cfg, batch, seq)    → decode-cache layout
"""

from repro_torch.models import attention, common, ffn, moe, ssm, transformer

__all__ = ["attention", "common", "ffn", "moe", "ssm", "transformer"]
