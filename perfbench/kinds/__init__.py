"""The traffic kinds.  A traffic mix (traffic/<mix>.json) names its kind;
registry.kind finds kinds/<kind>.py by that name.  A kind's module gives

  Driver(P, config, traffic, seed, device)  with .run(seconds, trace,
      t_start) -> (drivers.Window, kept) and .checked_items, the number of
      steps or frames the comparison recomputes;
  compare(driver, kept, opts) -> {number: value}, held to the
      configuration's limits["<kind>"];
  FAULTS, the faults (controls.faulty) its timed path can have, and
      short(traffic), the parameters calibrate.py's short runs change.
"""
