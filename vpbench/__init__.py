"""The benchmark of vorbispizza_tpu_torch on an NVIDIA H100 (see
README.md). Importing the package loads nothing: ``run`` is the entry
point, ``reference`` the plain reference the answers are held to."""
