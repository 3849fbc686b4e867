"""Entries: one module an entry, ``<name>.py``, found by the ``entry`` a
traffic file names.  An entry is how one call of the window hands its block
of load cases to the program:

- ``BLOCKS``: the block widths it takes (left out: any);
- ``prepare(solver, model)``: a check at set-up, which raises ValueError
  where the program would not solve the loads as given;
- ``solve(solver, fb)``: the call, inside its wall: ``fb`` is the block's
  global loads, (n_dof, block); returns (Krylov trips, a flag a column, a
  handle);
- ``answer(solver, handle)``: the displacements, (n_dof, block), fetched
  after the wall;
- ``dirichlet(model)``: the prescribed displacements each column's answer
  must hold on the fixed dofs (None: zero).
"""
