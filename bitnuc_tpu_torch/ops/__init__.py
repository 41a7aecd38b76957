"""Batch operations on packed reads (PyTorch counterparts of bitnuc_tpu.ops)."""
