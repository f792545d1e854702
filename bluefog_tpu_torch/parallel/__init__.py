"""Sequence parallelism on the rank-major backend (counterpart of
``bluefog_tpu/parallel``): :mod:`.ring_attention` (ring attention and its
striped layout) and :mod:`.ulysses`, each giving an ``attention_fn`` for
:class:`bluefog_tpu_torch.models.transformer.LlamaLM`.  The layout is
stated in :mod:`bluefog_tpu_torch.parallel.ring_attention`.  As in the
reference, this file re-exports nothing (``ring_attention`` names both a
module and its function).  The tensor, pipeline, expert and ZeRO layers
of the JAX package are not ported yet."""
