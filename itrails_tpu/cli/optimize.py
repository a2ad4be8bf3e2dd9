"""``itrails-tpu-optimize``: maximum-likelihood parameter inference.

CLI-compatible with the reference's ``itrails-optimize``
(workflow_optimize.py): same YAML schema, same artifacts
(.starting_params.yaml, .best_model.yaml checkpoint,
.optimization_history.csv), same parameter-case rules.
"""

from __future__ import annotations

import os

from itrails_tpu import __version__
from itrails_tpu.cli.common import (
    prepare_optimize_setup,
    resolve_io,
    resolve_optim_method,
    standard_parser,
)
from itrails_tpu.config import (load_config, load_yaml, seed_best_model,
                                write_starting_params)
from itrails_tpu.data.maf import maf_tokens
from itrails_tpu.optim.optimizer import optimizer


def main(argv=None):
    parser = standard_parser(
        "Optimize workflow using iTRAILS-TPU",
        usage="itrails-tpu-optimize <config.yaml> --output OUTPUT_PATH",
    )
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    parser.add_argument("--maxiter", type=int, default=None,
                        help="Optimizer iteration cap (overrides the "
                             "settings.maxiter config key; default 10000).")
    parser.add_argument("--precision", choices=["float32", "float64"],
                        default="float64")
    parser.add_argument("--grad", action="store_true",
                        help="Force the exact-gradient path (reverse-mode "
                             "AD through the model build and decode, "
                             "L-BFGS-B).  This is already the default "
                             "unless the config sets settings.method: "
                             "Nelder-Mead explicitly.")
    parser.add_argument("--no-grad", action="store_true",
                        help="Disable the exact-gradient path: run the "
                             "reference's derivative-free algorithm "
                             "(settings.method, default Nelder-Mead).")
    parser.add_argument("--resume", action="store_true",
                        help="Continue a previous run: restart from the "
                             "best parameters in <output>.best_model.yaml "
                             "and append to the optimization history.")
    parser.add_argument("--profile", type=str, default=None,
                        help="Write a jax.profiler trace of the run to DIR.")
    args = parser.parse_args(argv)

    config = load_config(args.config_file)
    maf_path, user_output, output_dir, output_prefix = resolve_io(config, args)
    print(f"Results will be saved to: {output_dir}.")

    setup = prepare_optimize_setup(config)
    settings = dict(setup["settings"])
    settings["output_prefix"] = user_output
    settings["input_maf"] = maf_path
    species = settings["species_list"]
    if settings.get("n_cpu"):
        from itrails_tpu.utils.resources import update_n_cpu

        update_n_cpu(settings["n_cpu"])

    best_model_yaml = os.path.join(output_dir, f"{output_prefix}.best_model.yaml")
    state_yaml = os.path.join(output_dir,
                              f"{output_prefix}.optimizer_state.yaml")
    resume = args.resume and (os.path.exists(best_model_yaml)
                              or os.path.exists(state_yaml))
    if resume:
        # Prefer the mid-run search-state checkpoint (the optimizer's last
        # iterate, written atomically every scipy iteration) over the
        # best-model YAML (reference README.md:36-40), which only records
        # the best-so-far point.
        if os.path.exists(state_yaml):
            st = load_yaml(state_yaml)
            for i, name in enumerate(setup["optim_variables"]):
                if name in st.get("variables", []):
                    setup["optim_list"][i] = float(
                        st["x_internal"][st["variables"].index(name)]
                    )
            print(f"Resuming from {state_yaml} "
                  f"(iterate after {st.get('n_eval', '?')} evaluations).")
        else:
            prev = load_yaml(best_model_yaml)
            mu = setup["mu"]
            prev_opt = prev.get("optimized_parameters") or {}
            for i, name in enumerate(setup["optim_variables"]):
                if name in prev_opt:
                    v = float(prev_opt[name])
                    setup["optim_list"][i] = (
                        v / mu if name == "r" else v if name == "m" else v * mu
                    )
            print(f"Resuming from {best_model_yaml} "
                  f"(loglik {prev['results']['log_likelihood']}).")
    else:
        write_starting_params(
            os.path.join(output_dir, f"{output_prefix}.starting_params.yaml"),
            setup["descaled_fixed"],
            setup["descaled_bounds"],
            settings,
        )
        seed_best_model(best_model_yaml, setup["descaled_fixed"], settings)

    print("Reading MAF alignment file.")
    v_lst = maf_tokens(maf_path, species)
    if not v_lst:
        raise ValueError("Error reading MAF alignment file.")
    print(f"{len(v_lst)} alignment blocks, "
          f"{sum(len(v) for v in v_lst)} columns.")

    use_grad, method = resolve_optim_method(setup, args.grad, args.no_grad)
    print(f"Running optimization ({method}"
          f"{', exact gradients' if use_grad else ''})...")
    from itrails_tpu.utils.profiling import trace

    with trace(args.profile):
        optimizer(
            optim_variables=setup["optim_variables"],
            optim_list=setup["optim_list"],
            bounds=setup["bounds_list"],
            fixed_params=setup["fixed_dict"],
            v_lst=v_lst,
            res_name=user_output,
            case=setup["case"],
            method=method,
            maxiter=(args.maxiter if args.maxiter is not None
                     else int(settings.get("maxiter") or 10000)),
            dtype=args.precision,
            header=not resume,
            use_grad=use_grad,
        )
    print(
        f"Optimization complete. Results saved to "
        f"{os.path.join(output_dir, f'{output_prefix}.optimization_history.csv')}.\n"
        f"Best model saved to "
        f"{os.path.join(output_dir, f'{output_prefix}.best_model.yaml')}."
    )


if __name__ == "__main__":
    main()
