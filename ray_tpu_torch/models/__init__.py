"""Models of the port over dict params with stacked ``[L, ...]`` block
leaves: the decoder LMs (GPT-2, dense or Switch-MoE; Llama), BERT, the
MLP, and KV-cache generation (``generate``)."""
