"""Traffic modes, one a file named after the "mode" of a traffic mix: each
holds KEYS, the mix's keys besides loadgen.COMMON_KEYS, and Mode."""
