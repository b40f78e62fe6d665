"""Device and vectorized-host compute kernels for tpuzlib."""
