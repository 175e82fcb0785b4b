"""One module per kind of traffic loop, found by the name in a traffic
file's ``"loop"`` key (``harness/spec.loop_kind``). Each defines

  Loop(model, cell, seed, inputs)  with
      warm_up()          every width the loop's work launches, once;
      window(seconds)    whole units of work until the seconds have passed:
                         {"window_s", "units", "failed", "counters",
                          "end_to_end": {metric: value}};
      record()           what the check reads of the window's outputs,
                         copied off the program's state;
  judge(ref, record, cell, inputs, seed, device) -> {number: value};
  control(ref, record, cell, inputs, seed, device) -> {name: {number: value}}:
      the numbers of the control and of the planted faults.

A new kind of traffic is a new module here and traffic files that name it.
"""
