"""The benchmark's harness: the yardstick that later changes to the program
are measured with (request generation, the reference's comparison, the
work and peak tables, the trace reduction). ``bench/run.py`` runs a cell.
"""
