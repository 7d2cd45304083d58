"""Plain references of the configurations' models.

Each module is a model's mathematics in plain PyTorch, written from the
published equations and independent of the program: it imports nothing of
``repro_torch`` (nor JAX or ``repro``), and computes in whatever dtype its
inputs have (float64 for the reference, bfloat16 for the control). A
configuration names its module by ``reference``; the module gives what the
loop of that configuration's cells calls.

The click models' contract, which ``yardstick/check.py`` and the loops
``train`` and ``serve_bulk`` call: two functions of ``p`` and ``batch``.
``p`` maps each leaf path of the configuration to a tensor: a hashed
table's entry is already gathered at the batch's ids, ``(B, K)``; any
other leaf is the whole leaf. ``batch`` holds ``positions`` (1-based),
``clicks`` and ``mask``.

* ``conditional_nll(p, batch)``: the training loss, the masked mean over
  items of -log P(C_k = c_k | c_<k).
* ``marginal_log_clicks(p, batch)``: ``(B, K)`` log P(C_k = 1), what
  serving returns.

A reference of another family (a language model's logits, say) gives what
its own loop calls; the loop hands it each leaf's start as
``yardstick.weights.rounded`` gives it at the leaf's dtype, the values the
program's leaf holds.
"""
