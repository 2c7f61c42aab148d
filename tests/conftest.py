import os

# Tests run on the CPU with 8 virtual devices, so the multi-device meshes
# run without cards. The jax config is set as well as the environment, in
# case a plugin backend was already chosen before this file ran; both must
# happen before any backend initializes.
os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                           + ' --xla_force_host_platform_device_count=8')

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_num_cpu_devices', 8)
