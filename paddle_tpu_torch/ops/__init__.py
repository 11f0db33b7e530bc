"""Ops of the port: the hand-written kernels' wrappers (``flash_attention``,
``paged_attention``, ``rms_norm``, ``kernels``, ...) and the paddle API's
op families (``math``, ``creation``, ``reduction``, ``logic``,
``manipulation``, ``random``, ``linalg``).  The API's op table is built by
``_table`` at the first top-level API name (``paddle_tpu_torch.<name>``),
so importing a kernel module does not build it."""

