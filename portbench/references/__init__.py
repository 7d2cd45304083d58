"""Plain references of the configurations' click models.

Each module is the model's mathematics in plain PyTorch, written from the
paper's equations and independent of the program: it imports nothing of
``repro_torch`` (nor JAX or ``repro``), and computes in whatever dtype its
inputs have (float64 for the reference, bfloat16 for the control).

A module gives two functions of ``p`` and ``batch``. ``p`` maps each leaf
path of the configuration to a tensor: a hashed table's entry is already
gathered at the batch's ids, ``(B, K)``; any other leaf is the whole
leaf. ``batch`` holds ``positions`` (1-based), ``clicks`` and ``mask``.

* ``conditional_nll(p, batch)``: the training loss, the masked mean over
  items of -log P(C_k = c_k | c_<k).
* ``marginal_log_clicks(p, batch)``: ``(B, K)`` log P(C_k = 1), what
  serving returns.
"""
