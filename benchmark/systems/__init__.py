"""Drivers of the measured package, one per kind of configuration: what the
harness builds, solves and reads through ``mlamg_torch``.

A driver is a class ``System(config, device, cache_dir)`` with ``n`` (the
operator's rows), ``operator(scale)``, ``rhs(x_true, scale)``,
``build(A)``, ``solve(h, b, tol)`` (returns x, cycles, converged),
``coarse_state(h)``, ``check_coarse(state, scale)``, ``control_state(state,
scale)``, ``residual(x, b, scale)`` and, optionally, ``start()``.

A driver whose configuration holds a dataset of operators (the grids of a
learned solver's test set, say) declares ``items``, their count, and
``n_of(item)``, each one's rows, in place of ``n``.  The harness then calls
``operator(scale, item)``, ``rhs(x_true, scale, item)`` and ``residual(x,
b, scale, item)``, and the driver's ``coarse_state(h)`` carries the item,
so that ``check_coarse`` and ``control_state`` need nothing more.  Such a
driver runs under a mix that draws items (``traffic/grid.json``); a driver
without ``items`` is called with no item, under any other mix.
"""
