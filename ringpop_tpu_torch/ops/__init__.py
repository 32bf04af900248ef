"""Device ops: Fingerprint32 (plain + kernel), ring lookups, and the packed-plane kernels of the sim engines."""
