import os
import re

from setuptools import setup, find_packages


def get_version():
    here = os.path.dirname(__file__)
    with open(os.path.join(here, 'proteus_jax', 'version.py')) as fh:
        text = fh.read()
    m = re.search(r"VERSION\s*=\s*['\"]([\d.]+)['\"]", text)
    if m is None:
        raise ValueError('malformed proteus_jax/version.py')
    return m.group(1)


setup(
    name='proteus_jax',
    version=get_version(),
    description='Dynamic Surface Water Extent (DSWx-HLS) framework: '
                'JAX/XLA science core with a self-contained GeoTIFF/COG '
                '+ geodesy runtime',
    packages=find_packages(include=['proteus_jax', 'proteus_jax.*']),
    package_data={'proteus_jax.config': ['defaults/*.yaml',
                                         'schemas/*.yaml']},
    python_requires='>=3.9',
    install_requires=['numpy', 'scipy', 'jax'],
    entry_points={
        'console_scripts': [
            'dswx_hls=proteus_jax.cli.dswx_hls:main',
            'dswx_compare=proteus_jax.cli.dswx_compare:main',
            'dswx_campaign=proteus_jax.cli.dswx_campaign:main',
        ],
    },
    scripts=['bin/dswx_hls.py', 'bin/dswx_compare.py'],
    url='https://github.com/opera-adt/PROTEUS',
    license='Apache-2.0',
)
