"""The plain reference that decides a benchmark run's ``correct``.

A frozen copy of the port's plain stages (its ``config`` and its twins
``ops/eigh3x3``, ``cellstats``, ``histogram``, ``growing``, ``merge`` and
``ransac``, as of the benchmark's first version), with its imports pointed
here: plain PyTorch, no kernel, no graph, nothing imported from the port and
nothing handed over from it. ``stages`` composes them from the depth frames
and the intrinsics to the pixel labels, the RANSAC draws included, and
``precision`` holds the control's TF32 rounding (the only change to the
copies: ``operand`` around the moments' and the distances' operands, the
identity outside ``precision.tf32()``).
"""
