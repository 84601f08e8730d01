"""One module a kind of executor, named by a configuration's ``executor``.

Each defines ``System(cell, seed, device, kernel)`` with:

  * ``build()``: the program's executors for ``ServingServer``;
  * ``server_opts()``: the server's keyword arguments;
  * ``counters(server)``: the program's counters, read at the window's
    open and close;
  * ``trace_launches(on)``: in a traced run, record what each
    kernel launch's bound needs, from the host-side step plan;
  * ``launch_bounds()``: the recorded launches' bounds by kernel name;
  * ``request_flops(traffic, rec)``: the model's operations for one
    answered request;
  * ``free()``: drop the program's state;
  * ``check(traffic, answered, control=False)``: run after ``free()``,
    so that whatever the reference makes (its weights too) is made after
    the window and after the peak is read; returns the numbers compared
    with the reference (``common.at_most`` / ``at_least`` records: name,
    value, limit, ok) and, with ``control``, the control's readings,
    among them ``control_correct``: the same comparison with the
    control's numbers in the program's place.
"""

import importlib


def load_system(name: str):
    return importlib.import_module(f"harness.systems.{name}").System
