"""Research artifacts that are not on any production path.

The exact Nussbaumer transform lost to the dense product on the hardware
this code base was first written for and has not been measured on the
H100 (ROADMAP D7); it stays tested until that measurement decides it.
"""
