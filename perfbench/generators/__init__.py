"""Data generators, one a configuration kind, found by the configuration's
"generator" key. Each makes its rows and its query pool on the device from
the seed and returns them on the host as the public API takes them."""
