"""The parallel strategies on the rank-major backend (counterpart of
``bluefog_tpu/parallel``): sequence parallelism (:mod:`.ring_attention`
and its striped layout, :mod:`.ulysses`, each giving an ``attention_fn``
for :class:`bluefog_tpu_torch.models.transformer.LlamaLM`), tensor
(:mod:`.tensor_parallel`), pipeline (:mod:`.pipeline`) and expert
(:mod:`.expert`) parallelism, the ZeRO-1 / FSDP train steps with machine
gossip (:mod:`.zero`) and the torus layout helpers (:mod:`.ici_map`).
Each module states its rank-major layout.  As in the reference, this file
re-exports nothing (``ring_attention`` names both a module and its
function)."""
