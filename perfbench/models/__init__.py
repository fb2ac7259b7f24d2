"""One module per model type (``<model_type>.py``), chosen by the
``model_type`` key of the configuration file and found by name, as metric
readers are. A model type's module turns a configuration into what the
harness needs and owns every count that depends on the block:

- ``port_kwargs(config) -> dict``: the port's ``TransformerConfig`` keywords
  (dtypes by name). It raises on a key it does not understand and on a
  value that would change the block in a way it cannot express.
- ``leaves(m) -> [(path, shape, std)]``: every leaf of the parameter tree in
  the order the weights are drawn; ``path`` is dotted ("layers.wq"), ``std``
  the normal's scale, or None for ones (a norm).
- ``matmul_params(m)``: weights one token passes through in matrix products,
  all layers (of experts, the active ones), the head left out;
  ``head_params(m)``; ``attn_fwd_flops(m, n)``: the causal attention of one
  sequence of n tokens, all layers, forward; ``decode_attn_flops(m, ctx)``:
  one token attending to ``ctx`` keys, all layers. ``metrics/_counts.py``
  makes the model's FLOPs from these.
- ``k1_bound(m, lengths)``: (bound seconds, launches) of the attention
  kernels of one prefill group; ``k4_bound(m, steps, page_size)``: the same
  of one decode block, ``steps`` the context lengths of each token step;
  ``train_attn_bounds(m, B, S)``: {kernel symbol: bound seconds of one
  launch} at a training step's shape.

Its plain reference is ``reference/<model_type>.py``, with
``served_gaps(params, m, seqs, control)`` and ``train_steps(params0, m,
batches, rows, fp8)``.
"""
