"""Module-level chatter switch for backend wrappers.

Capability parity with the reference's two-knob "flag system"
(reference raleigh/algebra/verbosity.py:3 and env.py:3).
"""

level = 0
