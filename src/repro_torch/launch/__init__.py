"""Entry points of the port: `launch.serve` (batched serving from the
store) and `launch.train` (training from the store); `launch.mesh` builds
the device context they run on."""
