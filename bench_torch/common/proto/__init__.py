"""Frozen copies of the MSK144 protocol definitions the benchmark needs.

constants.py, crc.py, ldpc_tables.py and msg77.py are copies of the port's
`constants.py` and `protocol/` modules as they stood when the benchmark was
written. The traffic generator packs its messages with them and the plain
reference decodes with them, so that neither depends on the program under
test: a later change to the program cannot move the yardstick.
"""
