"""The decode path as torch ops, with hand-written CUDA kernels for the
sync scan (scan.py), the survivor demod (survivor.py) and LDPC BP (ldpc.py);
kernels.py builds and binds them."""
