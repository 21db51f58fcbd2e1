"""The plain float64 reference: one file an entry, found by the entry's
name, over the dynamics of ``_rbd``. Imports nothing of the program."""
