"""Threads a C++ entropy decode of the window's calls was given: the sum of
stats["native_threads"] over the sum of stats["native_decodes"] (whole
streams and pieces of long ones), in threads; None where the program does
not count them."""


def read(run):
    threads = decodes = 0
    for c in run.calls:
        stats = c.stats or {}
        if "native_decodes" not in stats:
            return None
        threads += stats["native_threads"]
        decodes += stats["native_decodes"]
    return threads / decodes if decodes else None
