"""dswx_compare command-line entry point (golden product comparison)."""

import argparse

from proteus_jax.runtime.compare import compare_dswx_hls_products


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Compare two DSWx-HLS products',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('input_file', type=str, nargs=2,
                        help='Input images')
    args = parser.parse_args(argv)
    return compare_dswx_hls_products(args.input_file[0],
                                     args.input_file[1])


if __name__ == '__main__':
    main()
