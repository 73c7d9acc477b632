"""Data parallelism and the Pareto search: `mesh` (process groups and
collectives), `train_dp` (eval-network steps) and `pareto` (G searches
at once). Import the submodules: `mesh` is imported by the ops, so this
package imports nothing that would import them back."""
