"""Attention ops: oracles, the flash and paged-decode kernels, dispatch, sampling."""
