"""The benchmark's plain reference: a scalar FLAC frame encoder and a
plain FLAC decoder, in NumPy and Python integers.  It imports nothing of
the program under test and takes nothing the program made."""
