"""Hand-written CUDA kernels for Hopper, their build, wrappers and plain versions.

Nothing is compiled or loaded at import; see ``build.py``.
"""
