"""Device ops of the keyed-ownership path: Fingerprint32 (plain + kernel) and ring lookups."""
