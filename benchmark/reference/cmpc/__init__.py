"""Frozen copy of the plain PyTorch path of ``colaborativempc_tpu_torch``:
the LPV fleet step and the NL-OCD step with every kernel replaced by its
plain torch version, on any device and in any dtype. It imports nothing of
the port and nothing of JAX; the benchmark's reference and control run it
(``benchmark/reference/__init__.py``)."""
