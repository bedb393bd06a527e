"""Decoder families: all that the harness knows of a configuration's decoder.

A configuration file names its family in a ``"family"`` key (``dense``
where it has none), and ``manifest.cell`` loads ``families/<family>.py``
by that name, as it finds a driver. A family module gives:

  * ``widths(config) -> dict``: the decoder's sizes from the configuration
    file; ``num_hidden_layers`` among them (each layer launches the
    step's attention kernel once), and whatever else the family's other
    functions read;
  * ``groups(widths) -> {group: [(name, shape, init)]}``: the decoder's
    weights under the program's parameter names, in groups that
    ``portbench.weights`` draws from the seed. A group is what the
    reference remakes at a time, so a family may split a layer (its
    experts, say) to bound the reference's peak;
  * ``build_lm(config, widths, dtype)``: the port's decoder configuration,
    from the port's own entry point, checked key by key against
    ``widths``;
  * ``served_logits(widths, group, seqs, precisions, int8_pages, device)``:
    the plain f32 reference (``reference/<family>.py``, which imports
    nothing of the program);
  * the work the served tokens need, 2 FLOPs a multiply-add:
    ``prefill_flops(widths, n)`` for a prompt of ``n`` tokens (the head on
    its last position), ``decode_flops(widths, context)`` for one decode
    token whose query sees ``context`` keys, ``attention_flops(widths, n)``
    for the attention alone of a prompt of ``n`` tokens,
    ``kv_bytes(widths, keys, value_bytes)`` for the K and V cached for
    ``keys`` tokens, and ``decode_rows_bytes(widths)`` for one decode
    token's q and output rows.

Everything else (the weights' draw, the tower and projector, ``MMGPT``,
the int8 quantisation, the engine, the chip's peaks in ``yardstick``) is
the same for every family. A family module imports nothing of the program
at import time: the correctness check loads it.
"""
