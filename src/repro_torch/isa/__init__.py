"""The PANTHER hardware model on the port. Ported so far: ``energy``, the
§7.3-anchored constants and the packed-schedule pricing
(``EnergyModel.mvm_packed`` / ``opa_panther``) that Fig 10's IO sweep
prices with. The ISA, the compiler and the simulator are not ported yet."""
