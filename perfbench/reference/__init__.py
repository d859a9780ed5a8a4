"""The plain reference the output check holds the program against.

Plain torch and numpy, importing nothing of the program: the colouring and
blocked layout, the kernels' Philox-4x32-10 draws, the heat-bath sweeps of
a whole NMC / PT round and of the sequential sweep, the label swaps and the
convexified LBP backbone, each written out again from the configuration's
inputs. `replay` follows a round of an engine from a state it is handed.
"""
