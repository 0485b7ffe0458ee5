"""Plain float32 references that decide ``correct``.

Plain ``torch`` only: no module of the port, of JAX or of the JAX
package.  Every product runs in float32 with TF32 off
(:func:`float32_exact`).  ``quant`` in each forward rounds both
operands of every product to another precision (the control,
:mod:`.precision`).
"""
