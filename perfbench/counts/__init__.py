"""The benchmark's own counts of the work a target's gradient needs, one
module a target, named as the configuration's ``target``."""
